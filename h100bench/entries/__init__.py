"""The program's entries that a traffic mix drives, one module each, found
by the name in ``traffic/<traffic>.json`` (``"entry"``).

An entry builds the system under test from a configuration and the seed
(its set-up), warms up the shapes its traffic uses, serves the driver's
calls or orders, keeps a sample of what the timed path produced, and
after the window compares that sample with the reference
(``reference/pipeline.py``): ``numbers(cast)`` with ``cast=None`` reads
the program against the reference, and with a rounding reads the
reference computed at that precision, put in the program's place (the
control).
"""
