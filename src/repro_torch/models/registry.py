"""Model API over the ported families: ``build(cfg, device)`` ->
``ModelAPI`` (``repro/models/registry.py``). Every family of the reference
is ported: dense, MoE, VLM, the Jamba hybrid, the encoder-decoder and the
xLSTM.

Batch dicts hold ``{"tokens": (B, S) int tensor}`` (and ``"labels"`` for
the loss) on the API's device; a VLM's also ``"patches"`` (B, P, D), its
stub vision frontend's embeddings, placed before the tokens; an
encoder-decoder's ``"frames"`` (B, T_enc, D), its stub audio frontend's,
which the encoder reads.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import Family, ModelConfig, QuantConfig
from repro_torch.models import common as C
from repro_torch.models import encdec as ED
from repro_torch.models import hybrid as HY
from repro_torch.models import moe as MO
from repro_torch.models import transformer as TR
from repro_torch.models import vlm as VL
from repro_torch.models import xlstm as XL

Params = Dict[str, Any]

_FAMILIES = {Family.DENSE: TR, Family.MOE: MO, Family.VLM: VL,
             Family.HYBRID: HY, Family.ENCDEC: ED, Family.SSM: XL}

# the families with an attention KV cache, the only ones that take an int8
# one (the reference's list)
_KV_DTYPE_FAMILIES = (Family.DENSE, Family.MOE, Family.VLM, Family.HYBRID)


def family_module(cfg: ModelConfig):
    """The module of the config's family."""
    return _FAMILIES[cfg.family]


def _extra_kwargs(cfg: ModelConfig, batch: Dict[str, Any]) -> Dict[str, Any]:
    """The batch's inputs beside the tokens that the family's functions
    take (a VLM's patches, an encoder-decoder's frames)."""
    if cfg.family == Family.VLM:
        return {"patches": batch["patches"]}
    if cfg.family == Family.ENCDEC:
        return {"frames": batch["frames"]}
    return {}


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on: the card unless the caller asks
    for the CPU (or for ``meta``: the dry-run's shapes without data,
    ``launch/dryrun.py``). Asking for the card where there is none
    raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA was asked for but is not available; pass "
                           "device='cpu' to run the plain versions")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


@dataclasses.dataclass
class ModelAPI:
    cfg: ModelConfig
    device: torch.device
    mod: Any = dataclasses.field(init=False, repr=False)

    def __post_init__(self):
        self.mod = family_module(self.cfg)

    @property
    def sites(self) -> Tuple[str, ...]:
        """The sites of a layer (an encoder-decoder's: its decoder's)."""
        return self.mod.SITES

    def init_params(self, gen: Optional[torch.Generator] = None
                    ) -> C.ParamTree:
        """Seeded random weights from ``gen`` on its device (the API's).
        On meta (no generator: a ``torch.Generator`` has no meta device)
        the same tree, leaf for leaf, of shapes and dtypes only."""
        if self.device.type == "meta":
            if gen is not None:
                raise ValueError("a meta tree takes no generator")
            return self.mod.init_params(self.cfg, C.ShapesOnly())
        if gen is None or gen.device.type != self.device.type:
            raise ValueError(f"generator on "
                             f"{None if gen is None else gen.device}, model "
                             f"on {self.device}")
        return self.mod.init_params(self.cfg, gen)

    def loss_fn(self, params, batch, qcfg: QuantConfig, **kw):
        return self.mod.loss_fn(params, batch["tokens"], batch["labels"],
                                self.cfg, qcfg,
                                **_extra_kwargs(self.cfg, batch), **kw)

    def forward(self, params, batch, qcfg: QuantConfig, **kw):
        return self.mod.forward(params, batch["tokens"], self.cfg, qcfg,
                                **_extra_kwargs(self.cfg, batch), **kw)

    @property
    def _kv_mod(self):
        """The module whose prefill makes a token prefix's KV: the VLM's
        cushion is the dense stack's over the prefix tokens alone (it sits
        before the patches)."""
        return TR if self.cfg.family == Family.VLM else self.mod

    def _embed(self, params, ids: torch.Tensor, dtype) -> torch.Tensor:
        """Token embeddings of ``ids`` in ``dtype`` (the VLM's search puts
        them before the patches)."""
        w = C.as_tree(params)["embed"]["w"]
        return torch.nn.functional.embedding(ids.long(), w).to(dtype)

    def init_cache(self, batch: int, max_seq: int, dtype=None,
                   kv_dtype=None, prefix_len: int = 0,
                   per_slot_scales: bool = False):
        """``kv_dtype`` "int8": a quantized KV cache, for the families with
        an attention KV cache only (the others raise the reference's
        ValueError)."""
        if kv_dtype is not None and self.cfg.family not in _KV_DTYPE_FAMILIES:
            raise ValueError(
                f"kv_dtype={kv_dtype!r} unsupported for {self.cfg.family}")
        return self.mod.init_cache(self.cfg, batch, max_seq, self.device,
                                   dtype=dtype, kv_dtype=kv_dtype,
                                   prefix_len=prefix_len,
                                   per_slot_scales=per_slot_scales)

    def cache_roles(self, kv_dtype=None,
                    per_slot_scales: bool = False) -> Dict[str, Any]:
        """Every serving cache leaf's sharding roles (leaf name -> axis
        roles, nested for the xLSTM's state), which
        ``distributed/sharding.cache_shardings`` resolves on a mesh."""
        return self.mod.cache_roles(self.cfg, kv_dtype=kv_dtype,
                                    per_slot_scales=per_slot_scales)

    @property
    def cache_batch_axes(self) -> Dict[str, Any]:
        """Batch axis of every per-request cache leaf: the continuous
        scheduler's slot-scatter map. An entry may be a nested dict of
        per-leaf axes (the xLSTM's state tree)."""
        return self.mod.CACHE_BATCH_AXES

    @property
    def paged_kv_leaves(self) -> Tuple[str, ...]:
        """Cache leaves the paged pool re-lays into a flat page store;
        empty for the encoder-decoder (per-request cross-attention KV) and
        the xLSTM (recurrent state), which a paged pool refuses."""
        return tuple(getattr(self.mod, "PAGED_KV_LEAVES", ()))

    @property
    def supports_chunked_prefill(self) -> bool:
        """prefill() takes pos_offset to resume a staged B=1 fp row. The
        VLM (the patch prepend) and the hybrid (the Mamba state) admit
        blocking."""
        return bool(getattr(self.mod, "SUPPORTS_CHUNKED_PREFILL", False))

    def finalize_staged_kv(self, row, cache, cushion, S: int):
        """The blocking admission row, rebuilt from a finished chunk-staged
        fp row (int8 pools calibrate their per-slot scales here)."""
        return self.mod.finalize_staged_kv(row, cache, cushion, S)

    def prefill(self, params, batch, cache, qcfg: QuantConfig, **kw):
        return self.mod.prefill(params, batch["tokens"], cache, self.cfg,
                                qcfg, **_extra_kwargs(self.cfg, batch), **kw)

    def decode_step(self, params, token, pos, cache, qcfg: QuantConfig, **kw):
        return self.mod.decode_step(params, token, pos, cache, self.cfg,
                                    qcfg, **kw)

    def cushion_zeros(self, m: int, dtype=None):
        return self.mod.cushion_zeros(self.cfg, m, self.device, dtype=dtype)

    def forward_with_token_prefix(self, params, prefix_ids, batch,
                                  qcfg: QuantConfig, **kw):
        """Forward with a prefix of real tokens where the cushion will sit
        at deployment (the reference scorer of the greedy search, paper
        §4.1). prefix_ids: (m,), or (N, m) for N prefixes scored at once:
        the batch is then tiled once per prefix and the forward runs with
        ``groups=N`` (the reference vmaps one prefix at a time). A VLM's
        prefix is embedded and placed before the patches; an
        encoder-decoder's frames are tiled with the rows. Returns (logits,
        taps); callers pass collect / n_skip via kw."""
        toks = batch["tokens"]
        Bs, n = toks.shape
        ids = torch.as_tensor(prefix_ids, device=toks.device).to(toks.dtype)
        stacked = ids.dim() == 2
        N = int(ids.shape[0]) if stacked else 1
        ids = ids if stacked else ids[None]
        m = int(ids.shape[1])
        if stacked:
            kw["groups"] = N
        if self.cfg.family == Family.VLM:
            pt = batch["patches"]
            pre = self._embed(params, ids, pt.dtype)           # (N, m, D)
            pre = torch.cat([pre[:, None].expand(N, Bs, m, pre.shape[-1]),
                             pt[None].expand(N, *pt.shape)], dim=2)
            rows = toks[None].expand(N, Bs, n).reshape(N * Bs, n)
            return TR.forward(params, rows, self.cfg, qcfg,
                              prepend_embeds=pre.reshape(N * Bs,
                                                         *pre.shape[2:]),
                              **kw)
        full = torch.cat([ids[:, None].expand(N, Bs, m),
                          toks[None].expand(N, Bs, n)], dim=2)
        nb = dict(batch)
        nb["tokens"] = full.reshape(N * Bs, m + n)
        if "frames" in batch:
            fr = batch["frames"]
            nb["frames"] = fr[None].expand(N, *fr.shape).reshape(
                N * Bs, *fr.shape[1:])
        return self.forward(params, nb, qcfg, **kw)

    # ------------------------------------------------------------------
    # Greedy-search scoring fast path (KV reuse; paper §4.1)
    # ------------------------------------------------------------------
    #
    # The shared prefix is prefilled into a KV block once per search
    # iteration (`prefix_kv`); every candidate is scored by a forward of
    # [candidate; sample] against that block (`score_candidates`), the
    # no-candidate baseline by a forward of the sample alone
    # (`prefix_qerr`). All three take the prefix padded to a fixed length
    # and a live length (an int), so the shapes never change.

    @property
    def supports_kv_scoring(self) -> bool:
        return self.mod.SUPPORTS_PREFIX_KV_SCORING

    def prefix_kv(self, params, prefix_ids, qcfg: QuantConfig,
                  scales=None) -> Params:
        """Stacked per-layer KV {"k", "v": (L, m, K, hd)} of a token prefix.
        With a padded prefix the rows past the live length hold the padding
        tokens' KV; consumers mask them with ``prefix_valid``."""
        if not self.supports_kv_scoring:
            raise NotImplementedError(
                f"{self.cfg.family.value}: the prefix artifact is not "
                "attention KV only; use cushioncache.greedy_search_ref")
        m = int(prefix_ids.shape[0])
        mod = self._kv_mod
        cache = mod.init_cache(self.cfg, 1, m, self.device)
        ids = torch.as_tensor(prefix_ids, device=self.device)
        _, cache, _ = mod.prefill(params, ids[None], cache, self.cfg,
                                  qcfg, scales=scales)
        return {"k": cache["k"][:, 0], "v": cache["v"][:, 0]}

    def prefix_qerr(self, params, prefix_kv, live_len: int, batch,
                    qcfg: QuantConfig, scales=None) -> torch.Tensor:
        """L_q of the calibration sample after the cached prefix's first
        ``live_len`` rows (the search's base error)."""
        _, taps = self.forward(params, batch, qcfg, scales=scales,
                               cushion={"kv": prefix_kv}, collect=True,
                               n_skip=0, prefix_valid=int(live_len),
                               pos_offset=int(live_len), remat=False)
        return self.mod.total_qerr(taps)

    def score_candidates(self, params, prefix_kv, live_len: int, cand_ids,
                         batch, qcfg: QuantConfig, scales=None
                         ) -> torch.Tensor:
        """(N,) L_q of each candidate-extended prefix against the cached
        prefix: one forward of the N rows [candidate; sample] (each sample
        row tiled per candidate) with ``groups=N``, so each candidate keeps
        its own dynamic ranges and L_q, as under the reference's vmap. The
        candidate position is excluded from L_q (n_skip=1)."""
        if not self.supports_kv_scoring:
            raise NotImplementedError(
                f"{self.cfg.family.value}: KV-reuse scoring is not "
                "available; use cushioncache.greedy_search_ref")
        toks = batch["tokens"]
        Bs, n = toks.shape
        cand = torch.as_tensor(cand_ids, device=toks.device).to(toks.dtype)
        N = int(cand.shape[0])
        nb = dict(batch)
        if self.cfg.family == Family.VLM:
            # the candidate sits between the cushion and the patches
            pt = batch["patches"]
            ce = self._embed(params, cand, pt.dtype)            # (N, D)
            pre = torch.cat([ce[:, None, None].expand(N, Bs, 1, ce.shape[-1]),
                             pt[None].expand(N, *pt.shape)], dim=2)
            nb["patches"] = pre.reshape(N * Bs, *pre.shape[2:])
            nb["tokens"] = toks[None].expand(N, Bs, n).reshape(N * Bs, n)
        else:
            rows = torch.cat([cand[:, None, None].expand(N, Bs, 1),
                              toks[None].expand(N, Bs, n)], dim=2)
            nb["tokens"] = rows.reshape(N * Bs, n + 1)
        _, taps = self.forward(params, nb, qcfg, scales=scales,
                               cushion={"kv": prefix_kv}, collect=True,
                               n_skip=1, prefix_valid=int(live_len),
                               pos_offset=int(live_len), groups=N,
                               remat=False)
        return self.mod.total_qerr(taps, groups=N).reshape(N)

    def extract_cushion(self, params, prefix_ids: torch.Tensor, batch,
                        qcfg: QuantConfig) -> Params:
        """Turn a token prefix into the deployment cushion: its per-layer KV
        after one pass through the model (paper eq. 8), and for the hybrid
        also the Mamba layers' state after it; for the xLSTM the state
        after it alone ({"state": ...}, f32). A VLM's prefix runs without
        patches (the cushion sits before them), an encoder-decoder's under
        zero frames (a null acoustic context). ``batch`` is unused (kept
        for the reference's signature)."""
        m = int(prefix_ids.shape[0])
        toks = prefix_ids[None].to(self.device)
        if self.cfg.family == Family.SSM:
            _, _, states = XL.forward(params, toks, self.cfg, qcfg,
                                      return_cache=True, remat=False)
            return {"state": {g: {k: v[:, 0] for k, v in leaves.items()}
                              for g, leaves in states.items()}}
        mod = self._kv_mod
        cache = mod.init_cache(self.cfg, 1, m, self.device)
        kw = {}
        if self.cfg.family == Family.ENCDEC:
            kw["frames"] = torch.zeros(
                (1, self.cfg.encdec.encoder_seq, self.cfg.d_model),
                dtype=C.dtype_of(self.cfg), device=self.device)
        _, cache, _ = mod.prefill(params, toks, cache, self.cfg, qcfg, **kw)
        out = {"kv": {"k": cache["k"][:, 0, :m], "v": cache["v"][:, 0, :m]}}
        if self.cfg.family == Family.HYBRID:
            out["state"] = {"h": cache["h"][:, :, 0],
                            "conv": cache["conv"][:, :, 0]}
        return out

    def make_batch(self, gen: torch.Generator, batch: int, seq_len: int
                   ) -> Dict[str, torch.Tensor]:
        """A random batch {"tokens", "labels"} of ``seq_len`` positions in
        all on the API's device, drawn from a ``torch.Generator`` (the
        reference draws with ``jax.random``, which the port cannot
        reproduce: the same seed gives other ids); a VLM's also "patches",
        an encoder-decoder's "frames", normal x 0.02 in the model dtype,
        from the same generator."""
        toks = torch.randint(0, self.cfg.vocab_size,
                             (batch, self.text_len(seq_len) + 1),
                             generator=gen, device=gen.device,
                             dtype=torch.int32).to(self.device)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:],
                **self.extra_inputs(gen, batch)}

    def extra_inputs(self, gen: torch.Generator, batch: int
                     ) -> Dict[str, torch.Tensor]:
        """The family's inputs beside the tokens, drawn from ``gen`` on the
        API's device: a VLM's patches (B, P, D), an encoder-decoder's frames
        (B, T_enc, D), normal x 0.02 in the model dtype (the stub
        frontends' output); {} for the token-only families."""
        cfg = self.cfg
        if cfg.family == Family.VLM:
            key, n = "patches", cfg.vlm.num_patches
        elif cfg.family == Family.ENCDEC:
            key, n = "frames", cfg.encdec.encoder_seq
        else:
            return {}
        x = torch.randn((batch, n, cfg.d_model), generator=gen,
                        device=gen.device, dtype=C.dtype_of(cfg)) * 0.02
        return {key: x.to(self.device)}

    def text_len(self, seq_len: int) -> int:
        """Token count such that total positions == seq_len (a VLM's
        patches take ``num_patches`` of them)."""
        if self.cfg.family == Family.VLM:
            return max(1, seq_len - self.cfg.vlm.num_patches)
        return seq_len

    def input_specs(self, batch: int, seq_len: int
                    ) -> Dict[str, torch.Tensor]:
        """Meta stand-ins for every model input (the dry-run; the
        reference's ``ShapeDtypeStruct``s): ``tokens`` and ``labels``
        (batch, text_len) int32, a VLM's ``patches`` (batch, P, D), an
        encoder-decoder's ``frames`` (batch, T_enc, D), in the model
        dtype."""
        cfg = self.cfg
        meta = torch.device("meta")
        n = self.text_len(seq_len)
        out = {k: torch.empty((batch, n), dtype=torch.int32, device=meta)
               for k in ("tokens", "labels")}
        extra = {Family.ENCDEC: ("frames", getattr(cfg.encdec,
                                                   "encoder_seq", 0)),
                 Family.VLM: ("patches", getattr(cfg.vlm, "num_patches", 0))}
        if cfg.family in extra:
            key, m = extra[cfg.family]
            out[key] = torch.empty((batch, m, cfg.d_model),
                                   dtype=C.dtype_of(cfg), device=meta)
        return out


def build(cfg: ModelConfig, device="cuda") -> ModelAPI:
    return ModelAPI(cfg=cfg, device=resolve_device(device))
