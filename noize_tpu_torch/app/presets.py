"""Demo pipeline presets — port of ``noize_tpu.app.presets``: the
BasicDemo scene's stage assets (Perl, Simplex, Sin, GaussLF/HF, Sobel2D,
FlowMapStage) and its four pipeline compositions (DynamicNoise.unity),
with the same names, parameters and keyframes.

The two AnimationCurve assets (Invert, CurveBoostContrast) carry Unity
keyframes, evaluated with the exact Hermite keyframe math
(``utils.anim_curve``) into 256-sample LUTs (CurveStage.cs:26-34).

On the card ``PerlinGenerator`` and ``Sobel`` run their kernel filters on
K1 and ``FlowMap`` runs K2.
"""

from __future__ import annotations

from ..pipeline import stages as S
from ..pipeline.compose import PipelineDefinition
from ..utils.anim_curve import Keyframe

# --- stage assets -----------------------------------------------------------

PERL = S.NoiseStage(noiseType="Perlin", hurst=0.5938, startingAmplitude=1.0,
                    octaves=6, stepdown=1.9168, detuneRate=0.0317,
                    noiseSize=658)
SIMPLEX = S.NoiseStage(noiseType="Simplex", hurst=0.9001, octaves=6,
                       stepdown=2.0, detuneRate=0.0, noiseSize=7475)
SIN = S.NoiseStage(noiseType="Sin", hurst=0.87, octaves=5, stepdown=1.9607,
                   detuneRate=0.04, noiseSize=187)
GAUSS_LF = S.KernelFilterStage(filter="Gauss9_S1", iterations=2)
GAUSS_HF = S.KernelFilterStage(filter="Gauss3_S1", iterations=3)
SOBEL_2D = S.KernelFilterStage(filter="Sobel3_2D", iterations=1)
FLOW_MAP = S.FlowMapStage(iterations=1, normMin=0.0, normMax=0.005)
# keyframe data: BasicDemo~/Invert.asset m_Curve (7 keys, wrap = Clamp)
INVERT_KEYS = (
    Keyframe(0.0, 0.0, 0.0, 0.0, 0, 0.0, 0.0),
    Keyframe(0.3725787, -0.00043545663, -0.052437812, -0.052437812,
             0, 0.3434514, 0.17969078),
    Keyframe(0.49089807, 0.3703146, -0.69787115, -0.69787115,
             0, 0.33333334, 0.12081192),
    Keyframe(0.72000945, 0.82109743, -4.2246046, -4.2246046,
             0, 1.0, 0.09248569),
    Keyframe(0.7436102, 0.74109256, -0.2272283, -0.2272283,
             0, 0.33333334, 0.09776922),
    Keyframe(0.81110376, 0.7411803, -0.027698448, -0.027698448,
             0, 0.33333334, 0.09595265),
    Keyframe(1.0, 1.0, 0.0, 0.0, 0, 0.0, 0.0),
)
# keyframe data: BasicDemo~/CurveBoostContrast.asset m_Curve (4 keys)
CURVE_BOOST_CONTRAST_KEYS = (
    Keyframe(0.0, 0.0, -0.2922248, -0.2922248, 0, 0.0, 0.33333334),
    Keyframe(0.05752933, -0.016811498, 0.7459431, 0.7459431,
             0, 0.33333334, 0.2998635),
    Keyframe(0.47706693, 0.79677534, 1.1639355, 1.1639355,
             0, 0.33333334, 0.33333334),
    Keyframe(1.0, 1.0, 0.3886246, 0.3886246, 0, 0.33333334, 0.0),
)
INVERT = S.CurveStage.from_keyframes(INVERT_KEYS)
CURVE_BOOST_CONTRAST = S.CurveStage.from_keyframes(CURVE_BOOST_CONTRAST_KEYS)

# --- pipeline compositions (DynamicNoise.unity) ------------------------------

PERLIN_GENERATOR = PipelineDefinition(
    "PerlinGenerator", (SIMPLEX, GAUSS_LF, INVERT, GAUSS_HF)
)
FLOW_MAP_PIPELINE = PipelineDefinition(
    "FlowMap", (PERL, INVERT, FLOW_MAP, CURVE_BOOST_CONTRAST)
)
SOBEL_PIPELINE = PipelineDefinition(
    "Sobel", (GAUSS_HF, GAUSS_LF, SOBEL_2D, CURVE_BOOST_CONTRAST)
)
MESH_PIPELINE = PipelineDefinition("Mesh", (S.MeshTileStage(overshoot=False),))

ALL = {
    p.name: p for p in (
        PERLIN_GENERATOR, FLOW_MAP_PIPELINE, SOBEL_PIPELINE, MESH_PIPELINE,
    )
}
