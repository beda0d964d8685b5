"""Contract specs for stages (``specs``)."""
