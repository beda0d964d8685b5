"""Kernel designs that were measured on the card and not taken, and
controls that explain a path's numbers; each file says what it tried and
``PERF.md`` gives its readings. Nothing here is on a path."""
