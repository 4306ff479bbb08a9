"""Model factory (port of wire_tpu/nn/registry.py:20-78 and get_inr):
WIRE, WIRE-2D, the canonical real families (siren, gauss, relu, posenc
and the B-splines form, cubic, srelu and knots), the Gabor MFN and the
multiscale B-splines mscale_2, mscale_HL and mscale_hier.  The JAX
registry's TPU lane guidance (``hidden_gemm_width``, ``LANE_NATIVE``,
``lane_waste``: 128-lane MXU padding) has no counterpart on the GPU."""
from __future__ import annotations

from wire_tpu_torch.nn import models as M
from wire_tpu_torch.nn.models import INR, INRSpec

# nonlin name -> (init_fn, apply_fn)
MODEL_REGISTRY = {
    "wire": (M.wire_init, M.wire_apply),
    "wire2d": (M.wire2d_init, M.wire2d_apply),
    "siren": (M.siren_init, M.siren_apply),
    "gauss": (M._plain_mlp_init, M.gauss_apply),
    "relu": (M.relu_init, M.relu_apply),
    "posenc": (M.relu_init, M.relu_apply),
    "mfn": (M.mfn_init, M.mfn_apply),
    "bspline_form": (M.bspline_plain_init, M.bspline_form_apply),
    "bspline_cubic": (M.bspline_plain_init, M.bspline_cubic_apply),
    "bspline_srelu": (M.bspline_plain_init, M.bspline_srelu_apply),
    "bspline_knots": (M.bspline_plain_init, M.bspline_knots_apply),
    "bspline_mscale_2": (M.mscale2_init, M.mscale2_apply),
    "bspline_mscale_HL": (M.mscale_hl_init, M.mscale_hl_apply),
    "bspline_mscale_hier": (M.mscale_hier_init, M.mscale_hier_apply),
}

# families with a train-step kernel; the rest take autodiff of apply
STEP_REGISTRY = {
    "wire": M.wire_step,
    "wire2d": M.wire2d_step,
    "siren": M.siren_step,
    "gauss": M.gauss_step,
    "relu": M.relu_step,
    "posenc": M.relu_step,
    "mfn": M.mfn_step,
    "bspline_form": M.bspline_form_step,
    "bspline_cubic": M.bspline_cubic_step,
    "bspline_srelu": M.bspline_srelu_step,
    "bspline_knots": M.bspline_knots_step,
    "bspline_mscale_2": M.mscale2_step,
    "bspline_mscale_HL": M.mscale_hl_step,
    "bspline_mscale_hier": M.mscale_hier_step,
}

# default (first_omega0, hidden_omega0, scale) per family, as each
# reference module's __init__ defaults
_FAMILY_DEFAULTS = {
    "wire": dict(first_omega0=30.0, hidden_omega0=30.0, scale=10.0),
    "wire2d": dict(first_omega0=10.0, hidden_omega0=10.0, scale=10.0),
    "siren": dict(first_omega0=30.0, hidden_omega0=30.0, scale=10.0),
    "gauss": dict(scale=10.0),
    "relu": dict(),
    "posenc": dict(),
    "mfn": dict(),
}


def get_inr(nonlin: str, **kwargs) -> INR:
    """Build an INR model instance from the reference factory's keyword
    surface (in_features, hidden_features, scaled_hidden_features,
    hidden_layers, out_features, outermost_linear, first_omega0,
    hidden_omega0, scale, scale_tensor, pos_encode, sidelength, fn_samples,
    use_nyquist, detach_split, base_split, combine_type and ``fused``).
    ``posenc`` is relu with pos_encode on."""
    if nonlin not in MODEL_REGISTRY:
        raise KeyError(f"Unknown nonlin {nonlin!r}; available: "
                       f"{sorted(MODEL_REGISTRY)}")
    kw = dict(_FAMILY_DEFAULTS.get(nonlin, {}))
    for ref_name, ours in (("first_omega_0", "first_omega0"),
                           ("hidden_omega_0", "hidden_omega0")):
        if ref_name in kwargs:
            kwargs[ours] = kwargs.pop(ref_name)
    kw.update(kwargs)
    if nonlin == "posenc":
        kw.setdefault("pos_encode", True)
    if kw.get("scale_tensor") is not None:
        kw["scale_tensor"] = tuple(float(s) for s in kw["scale_tensor"])
    spec = INRSpec(nonlin=nonlin, **kw)
    init_fn, apply_fn = MODEL_REGISTRY[nonlin]
    return INR(spec, init_fn, apply_fn, step_fn=STEP_REGISTRY.get(nonlin))
