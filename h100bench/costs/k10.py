"""K10, the fBm (``csrc/fractal.cu``): float32 operations a cell an octave,
counted from the kernel's source (each ``__f*_rn``, floorf, fabsf, compare,
select, min and max one; sinf and cosf 20 each, fmodf 10, __fsqrt_rn 8; the
octave's own f·x, f·z, a·v and sum 4), a frozen copy of
``noize_tpu_torch.ops.cuda.fractal.OPS_PER_OCTAVE`` and ``OPS_PER_CELL``.
Nothing is read; each cell is written once."""

OPS_PER_OCTAVE = {
    "Sin": 49,
    "Perlin": 190,
    "PeriodicPerlin": 312,
    "Simplex": 168,
    "RotatedSimplex": 312,
    "Cellular": 358,
    "DomainRotatedPerlin": 605,
    "DomainRotatedSimplex": 412,
}
OPS_PER_CELL = 12


def cost(cells: int, noise_type: str, octaves: int):
    """(float32 ops, bytes) of one fBm over ``cells`` cells."""
    return cells * (OPS_PER_OCTAVE[noise_type] * octaves + OPS_PER_CELL), 4 * cells
