"""lif_tpu_torch: the PyTorch + CUDA port of lif_tpu, for NVIDIA Hopper.

A second package beside the JAX one (lif_tpu, the reference). It mirrors
lif_tpu's layout and names; each TPU kernel of a ported path becomes a
hand-written CUDA kernel (csrc/), compiled by nvcc at first use. Ported
so far: LIF files in (io/: the container codec, with its C++ copy built
by g++ at first use, metadata normalization, and image decode, PNG
without PIL) and the loaders (load_lif_file, LifLoader,
projector_from_lif_view, resample_projector); the exact ray march;
render_fast_view (render(mode='fast')) and render_depth_fast; the five
tiers of render_fast_batch: the lateral snap-plane march ('march', with
the frustum-skew fold), the scaled march for other unrotated poses
('scaled'), the orbit's target-ray march ('target': yaw-family poses,
and pitch-family poses through an x<->y transpose), the two-phase
fallback for other rotated poses ('rotated') and the plane sweep
('sweep', ops/sweep_fast.py: method='sweep', exact_color and the
fallback of the layers and poses no march tier covers, which warns
models.renderer.TierFallbackWarning); scene fitting (train/:
fit_projector, gradient refinement of depth and pose by autograd through
the soft plane sweep ops/sweep.py, with torch.optim.Adam); the mesh modes,
render(mode='billboard' | 'mesh') and, for lateral pose batches,
render_billboard_fast_batch (the billboard splat as a row z-buffer
scatter); the stereo modes, render_stereo_view (render(mode='stereo'),
the exact two-view march) and render_stereo_fast /
render_stereo_fast_batch (render(mode='stereo_fast'), the same blend on
the march tiers); multi-projector fusion, render_fused_fast /
render_fused_fast_batch (the nearest-surface merge on the lateral march)
and its exact oracle parallel.sharding.render_fused_projectors;
multi-device rendering and fitting over torch.distributed
(parallel.sharding: make_mesh, render_view_tiled,
render_trajectory_sharded, render_fast_trajectory_sharded, the mesh form
of render_fused_projectors, and train.fit.fit_projector(mesh=...);
parallel.launch.run_ranks starts the ranks of a one-host run; entry holds
the forward check and the multi-rank dry run); models.scene (LayerGroup,
Scene), apps.viewer and apps.picking; utils.debug and utils.profiling.
As in lif_tpu, the top level exports the render and load entry points;
the tiers' functions stay in lif_tpu_torch.ops and the fit in
lif_tpu_torch.train. It imports neither jax nor lif_tpu.
"""

__version__ = "0.1.0"

from .config import DEFAULT_CONFIG, RenderConfig  # noqa: F401
from .core.camera import Camera  # noqa: F401
from .core.pose import (  # noqa: F401
    lif_rotation_to_matrix,
    lif_rotation_to_quaternion,
    orbit_pose,
)
from .models.api import (  # noqa: F401
    LifLoader,
    LoadLifFileResult,
    load_lif_file,
    orbit_center_from_stereo_data,
    synthesize_projector,
)
from .models.projector import (  # noqa: F401
    Projector,
    projector_from_arrays,
    projector_from_lif_view,
    projector_from_reference,
    resample_projector,
)
from .models.renderer import (  # noqa: F401
    RenderMode,
    render,
    render_billboard_fast_batch,
    render_depth_fast,
    render_fast_batch,
    render_fast_view,
    render_fused_fast,
    render_fused_fast_batch,
    render_mono_view,
    render_stereo_fast,
    render_stereo_fast_batch,
    render_stereo_view,
)
from . import train  # noqa: F401,E402
