"""The port's counterparts of ``transmogrifai_tpu.examples``."""
