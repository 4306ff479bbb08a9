"""Experiment presets (port of wire_tpu/train/presets.py:20-146): the
B-spline (bspline_form) and WIRE entries of the reference's named
experiment configs, with the same key-values (a few entries keep a
``name`` that differs from their key, as in the reference, so artifact
folder names match).

Select presets with ``get_config(name)``; list with ``list_configs()``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    name: str
    nonlin: str
    scale: float
    scale_tensor: tuple
    learning_rate: Any              # float or tuple (per-stage groups)
    scaled_hidden_features: int = 256
    hidden_features: int = 256
    niters: int = 2000
    tau: float = 3e1
    noise_snr: float = 2
    tvl: bool = False
    lambda_tv: float = 0.0
    maxpoints: int = 256 * 256
    omega0: Optional[float] = None      # WIRE presets override per-task omega
    down_scale: Optional[int] = None    # SISR only
    added_noise: Optional[bool] = None  # SISR/CT only


ENTRIES = {
    'Bspline_s9_5_LR8e3_E4000': dict(nonlin='bspline_form', scale=0.10526315789473684, scale_tensor=(0.0,), scaled_hidden_features=0, learning_rate=0.008, niters=4000),
    'Bspline_s9_LR1e3_E2000': dict(nonlin='bspline_form', scale=0.1111111111111111, scale_tensor=(0.0,), scaled_hidden_features=0, learning_rate=0.001, down_scale=4, added_noise=False),
    'Bspline_s9_LR1e3_E1500': dict(nonlin='bspline_form', scale=0.1111111111111111, scale_tensor=(0.0,), scaled_hidden_features=0, learning_rate=0.001, niters=1500, down_scale=4, added_noise=False),
    'Bspline_s16_LR1e3_E2000': dict(nonlin='bspline_form', scale=0.0625, scale_tensor=(0.0,), scaled_hidden_features=0, learning_rate=0.001, down_scale=4, added_noise=False),
    'Bspline_s4_LR8e3_E4000': dict(nonlin='bspline_form', scale=0.25, scale_tensor=(0.0,), scaled_hidden_features=0, learning_rate=0.008, niters=4000),
    'Bspline_s4_LR8e3_E4000_T3e1_SNR2': dict(nonlin='bspline_form', scale=0.25, scale_tensor=(0.0,), scaled_hidden_features=0, learning_rate=0.008, niters=4000, added_noise=True),
    'Bspline_Noise_s9_LR1e3_E2000': dict(nonlin='bspline_form', scale=0.1111111111111111, scale_tensor=(0.0,), scaled_hidden_features=0, learning_rate=0.001, down_scale=4, added_noise=True),
    'Bspline_s9_Ds6_LR1e3_E2000': dict(nonlin='bspline_form', scale=0.1111111111111111, scale_tensor=(0.0,), scaled_hidden_features=0, learning_rate=0.001, down_scale=6),
    'Bspline_s9_Ds8_LR1e3_E2000': dict(nonlin='bspline_form', scale=0.1111111111111111, scale_tensor=(0.0,), scaled_hidden_features=0, learning_rate=0.001, down_scale=8),
    'Bspline_s9_Ds16_LR1e3_E2000': dict(nonlin='bspline_form', scale=0.1111111111111111, scale_tensor=(0.0,), scaled_hidden_features=0, learning_rate=0.001, down_scale=16),
    'Bspline_s9_5_LR8e3_E4000_snr1_tau1e1': dict(nonlin='bspline_form', scale=0.10526315789473684, scale_tensor=(0.0,), scaled_hidden_features=0, learning_rate=0.008, niters=4000, tau=10.0, noise_snr=1),
    'Bspline_s9_5_LR8e3_E4000_snr1_tau0.5e1': dict(nonlin='bspline_form', scale=0.10526315789473684, scale_tensor=(0.0,), scaled_hidden_features=0, learning_rate=0.008, niters=4000, tau=5.0, noise_snr=1),
    'Bspline_s9_5_LR8e3_E4000_snr1_tau0.2e1': dict(nonlin='bspline_form', scale=0.10526315789473684, scale_tensor=(0.0,), scaled_hidden_features=0, learning_rate=0.008, niters=4000, tau=2.0, noise_snr=1),
    'WIRE_s8_o7_LR5e3_E2000': dict(nonlin='wire', scale=8.0, scale_tensor=(0.0,), scaled_hidden_features=0, learning_rate=0.005, hidden_features=300, omega0=7.0),
    'WIRE_s8_o7_LR1e2_E2000': dict(nonlin='wire', scale=8.0, scale_tensor=(0.0,), scaled_hidden_features=0, learning_rate=0.005, hidden_features=300, omega0=7.0, name='WIRE_s8_o7_LR5e3_E2000'),
    'WIRE_s9_o8_LR5e3_E2000': dict(nonlin='wire', scale=9.0, scale_tensor=(0.0,), scaled_hidden_features=0, learning_rate=0.005, omega0=8.0, down_scale=4, added_noise=False),
    'WIRE_s12_o8_LR5e3_E2000': dict(nonlin='wire', scale=12.0, scale_tensor=(0.0,), scaled_hidden_features=0, learning_rate=0.005, omega0=3.0),
    'WIRE_s12_o8_LR5e3_E2000_T3e1_SNR2': dict(nonlin='wire', scale=12.0, scale_tensor=(0.0,), scaled_hidden_features=0, learning_rate=0.005, omega0=3.0, added_noise=True),
    'WIRE_s8_o7_LR5e3_E4000_snr1_tau1e1': dict(nonlin='wire', scale=8.0, scale_tensor=(0.0,), scaled_hidden_features=0, learning_rate=0.005, hidden_features=300, niters=4000, tau=10.0, noise_snr=1, omega0=7.0),
    'WIRE_s8_o7_LR5e3_E2000_snr1_tau0.5e1': dict(nonlin='wire', scale=8.0, scale_tensor=(0.0,), scaled_hidden_features=0, learning_rate=0.005, hidden_features=300, tau=5.0, noise_snr=1, omega0=7.0, name='WIRE_s8_o7_LR5e3_E4000_snr1_tau0.5e1'),
    'WIRE_s8_o7_LR5e3_E2000_snr1_tau0.2e1': dict(nonlin='wire', scale=8.0, scale_tensor=(0.0,), scaled_hidden_features=0, learning_rate=0.005, hidden_features=300, tau=2.0, noise_snr=1, omega0=7.0, name='WIRE_s8_o7_LR5e3_E4000_snr1_tau0.2e1'),
    'WIRE_Noise_s9_o8_LR5e3_E2000': dict(nonlin='wire', scale=9.0, scale_tensor=(0.0,), scaled_hidden_features=0, learning_rate=0.005, omega0=8.0, down_scale=4, added_noise=True),
    'WIRE_s9_Ds6_o8_LR5e3_E2000': dict(nonlin='wire', scale=9.0, scale_tensor=(0.0,), scaled_hidden_features=0, learning_rate=0.005, omega0=8.0, down_scale=6, added_noise=False),
    'WIRE_s9_Ds8_o8_LR5e3_E2000': dict(nonlin='wire', scale=9.0, scale_tensor=(0.0,), scaled_hidden_features=0, learning_rate=0.005, omega0=8.0, down_scale=8, added_noise=False),
    'WIRE_s9_Ds16_o8_LR5e3_E2000': dict(nonlin='wire', scale=9.0, scale_tensor=(0.0,), scaled_hidden_features=0, learning_rate=0.005, omega0=8.0, down_scale=16, added_noise=False),
}


def get_config(name: str) -> ExperimentConfig:
    if name not in ENTRIES:
        raise KeyError(f"Unknown config {name!r}; see list_configs()")
    e = dict(ENTRIES[name])
    e.setdefault("name", name)
    lr = e.get("learning_rate")
    if isinstance(lr, (list, tuple)):
        e["learning_rate"] = tuple(lr)
    e["scale_tensor"] = tuple(e.get("scale_tensor", ()))
    return ExperimentConfig(**e)


def list_configs() -> Sequence[str]:
    return sorted(ENTRIES)
