"""Particle erosion: world state, descent, sediment, pool automata, cycle."""
