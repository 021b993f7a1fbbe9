"""Static-range calibration (paper §5.1), ported from
``repro/core/calibration.py``: run instrumented forwards over calibration
batches, merge activation statistics, derive per-site static scales."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, NamedTuple, Optional

import torch

from repro_torch.configs.base import Family, QuantConfig
from repro_torch.core import quantization as Q

NON_SITES = ("block_in", "final_in")


class CalibratedScales(NamedTuple):
    """Static scales plus the fingerprint of the cushion they were
    calibrated under (``"none"`` without one); serving refuses them under
    another cushion."""
    scales: Any
    cushion_fp: str


def calibrate_tagged(api, params, batches: Iterable[Dict[str, Any]],
                     qcfg: QuantConfig, cushion=None, n_skip: int = 0):
    """``calibrate``, with the scales wrapped in their cushion provenance.
    Returns (CalibratedScales, merged_stats)."""
    from repro_torch.core.cushioncache import cushion_fingerprint
    scales, merged = calibrate(api, params, batches, qcfg, cushion=cushion,
                               n_skip=n_skip)
    return CalibratedScales(scales, cushion_fingerprint(cushion)), merged


def _map_scales(fn, tree):
    if isinstance(tree, Q.SiteScale):
        return fn(tree)
    return {k: _map_scales(fn, v) for k, v in tree.items()}


def scales_to_plain(scales: Any) -> Any:
    """SiteScale leaves -> plain ``{"scale", "zero"}`` dicts."""
    return _map_scales(lambda s: {"scale": s.scale, "zero": s.zero}, scales)


def scales_from_plain(tree: Any) -> Any:
    """Inverse of ``scales_to_plain``."""
    if isinstance(tree, dict) and set(tree) == {"scale", "zero"}:
        return Q.SiteScale(scale=torch.as_tensor(tree["scale"]),
                           zero=torch.as_tensor(tree["zero"]))
    return {k: scales_from_plain(v) for k, v in tree.items()}


def taps_to_stats(taps: Dict[str, Any]) -> Dict[str, Any]:
    """Keep the sites of a taps tree (the layers', an encoder's
    ``enc_layers``, the head's), and of each its {amin, amax,
    absmax_ch}."""
    def clean(site):
        return {"amin": site["amin"], "amax": site["amax"],
                "absmax_ch": site["absmax_ch"]}
    out: Dict[str, Any] = {}
    for key in ("layers", "enc_layers"):
        if key in taps:
            out[key] = {k: clean(v) for k, v in taps[key].items()
                        if k not in NON_SITES}
    if "head" in taps:
        out["head"] = clean(taps["head"])
    return out


def stats_to_scales(stats: Dict[str, Any], qcfg: QuantConfig,
                    family: Family) -> Dict[str, Any]:
    """{site: SiteScale (L,), ..., "head": SiteScale ()}: the dense layout,
    which the MoE and VLM families share (their sites are qkv, o, mlp_in
    and down), the hybrid's over its periods (with mamba_in and mamba_out,
    one scale a period and site) and the xLSTM's over its pairs (m_in,
    m_out, s_in, s_out); an encoder-decoder's is {"enc": {site: (E,)},
    "dec": {site: (L,)}, "head"}."""
    if family == Family.ENCDEC:
        out = {"enc": Q.scales_from_stats(stats["enc_layers"], qcfg),
               "dec": Q.scales_from_stats(stats["layers"], qcfg)}
    else:
        out = Q.scales_from_stats(stats["layers"], qcfg)
    if "head" in stats:
        out["head"] = Q.scales_from_stats({"head": stats["head"]},
                                          qcfg)["head"]
    return out


@torch.inference_mode()
def calibrate(api, params, batches: Iterable[Dict[str, Any]],
              qcfg: QuantConfig, cushion=None, n_skip: int = 0):
    """Collect stats over ``batches`` (unquantized forwards, under the
    cushion when one is given: the scales describe the deployment
    distribution) and return (scales, merged_stats)."""
    merged: Optional[Dict[str, Any]] = None
    obs_cfg = dataclasses.replace(qcfg, mode="none")
    for batch in batches:
        _, taps = api.forward(params, batch, obs_cfg, cushion=cushion,
                              collect=True, n_skip=n_skip)
        merged = Q.merge_stats(merged, taps_to_stats(taps))
    if merged is None:
        raise ValueError("empty calibration set")
    return stats_to_scales(merged, qcfg, api.cfg.family), merged
