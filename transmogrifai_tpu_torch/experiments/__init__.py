"""Kernel designs that were measured on the card and not taken; each file
says what it tried and ``PERF.md`` gives its readings. Nothing here is on
a path."""
