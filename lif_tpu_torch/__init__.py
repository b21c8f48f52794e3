"""lif_tpu_torch: the PyTorch + CUDA port of lif_tpu, for NVIDIA Hopper.

A second package beside the JAX one (lif_tpu, the reference). It mirrors
lif_tpu's layout and names; each TPU kernel of a ported path becomes a
hand-written CUDA kernel (csrc/), compiled by nvcc at first use. Ported
so far: the exact ray march, and four tiers of render_fast_batch: the
lateral snap-plane march ('march'), the scaled march for other unrotated
poses ('scaled'), the orbit's target-ray march ('target': yaw-family
poses, and pitch-family poses through an x<->y transpose) and the
two-phase fallback for other rotated poses ('rotated'); and the mesh
modes, render(mode='billboard' | 'mesh') and, for lateral pose batches,
render_billboard_fast_batch (the billboard splat as a ladder gather).
As in lif_tpu, the top level exports the render entry points; the tiers'
functions stay in lif_tpu_torch.ops. It imports neither jax nor lif_tpu.
"""

__version__ = "0.1.0"

from .config import DEFAULT_CONFIG, RenderConfig  # noqa: F401
from .core.camera import Camera  # noqa: F401
from .core.pose import orbit_pose  # noqa: F401
from .models.projector import (  # noqa: F401
    Projector,
    projector_from_arrays,
    projector_from_reference,
)
from .models.renderer import (  # noqa: F401
    render,
    render_billboard_fast_batch,
    render_fast_batch,
    render_mono_view,
)
