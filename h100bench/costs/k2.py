"""K2, the flow map (``csrc/flow.cu``): the flow step (25) and the water
step (10) an iteration, the velocity and the normalisation (14) once, a
cell; the height read once and the map written once."""

OPS_PER_ITER = 35
OPS_ONCE = 14


def cost(cells: int, iterations: int):
    """(float32 ops, bytes) of ``iterations`` of the flow map over ``cells``
    cells."""
    return (OPS_PER_ITER * iterations + OPS_ONCE) * cells, 8 * cells
