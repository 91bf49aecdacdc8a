"""Drivers: one per kind of traffic, found by the ``driver`` key of a
traffic file. A driver builds the program under test from a configuration
and the seed, drives its public entry points, and checks what they produced
against the plain reference.

Every driver has the same methods, which ``run.py`` calls in this order:
``setup()``; then ``window(seconds)`` (the timed calls) or ``traced()`` (one
call under the profiler), each returning (end-to-end values, counters);
``release()`` (frees the program's state); ``check()``, which returns the
compared numbers as {name: value}.
"""
