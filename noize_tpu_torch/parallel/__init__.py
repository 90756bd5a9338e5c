"""One-device tiled generation (the rest of ``parallel/`` is not ported yet)."""
