from wire_tpu_torch.dist.mesh import make_mesh  # noqa: F401
from wire_tpu_torch.dist.fitter import (  # noqa: F401
    fit_frames_sharded, fit_operator_sharded, fit_pointwise_sharded)
from wire_tpu_torch.dist import multihost  # noqa: F401
