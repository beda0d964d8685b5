"""Multi-device helpers (counterpart of ``transmogrifai_tpu.parallel``).
Only the guarded host<->device transfers are ported
(``distributed.fetch_to_host``, ``distributed.retrying_device_put``); the
process group, meshes and collectives wait (ROADMAP Queue 1 item 10)."""
