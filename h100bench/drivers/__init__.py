"""Traffic drivers, one module each, found by the name in
``traffic/<traffic>.json`` (``"driver"``).  ``run(entry, traffic, seed,
seconds, trace)`` runs the measured window on an entry that has been set
up and warmed, and returns a ``Window``."""
