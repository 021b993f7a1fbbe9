"""The JAX package's training, and the bars the port's tensor-parallel
training is held to, for the tests that spawn it
(``test_torch_sharding.py``: paper_tiny at tp = 2;
``test_torch_replica_tp.py``: data 2 x tp 2; ``test_torch_tp_families.py``:
the VLM, the encoder-decoder and the xLSTM at tp = 2 and 4). Not a test
module: it imports jax, so no spawned rank imports it.

paper_tiny's run is test_torch_train.py's: JAX's paper_tiny weights
(``PRNGKey(0)``), the launcher's pipeline batches (B = 2 x 32), lr 1e-3,
warmup 10; six steps of ``make_train_step`` on one device under ``none``
(the function GSPMD partitions), and the first step's loss and gradient
under each quantized mode, with the port's pt_static scales calibrated on
two of the batches. The other families' (``family_batches``,
``first_steps``): seeded numpy batches of tokens with a VLM's patches or
an encoder-decoder's frames, and the first step's loss, CE, gradient norm
and first moment on one device under each mode asked for (test_torch_train.py
builds the same per family).
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import QuantConfig as JQ
from repro.configs import RunConfig as JRun
from repro.core import quantization as JQU
from repro.train import trainer as JT
from repro_torch.configs import QuantConfig
from repro_torch.core.calibration import calibrate
from repro_torch.data.pipeline import Pipeline, SyntheticCorpus
from repro_torch.models import convert
from repro_torch.models.registry import build
from repro_torch.serving.engine import shard_tree

B, S, STEPS = 2, 32, 6
RESUME = dict(rtol=1e-5, atol=1e-6)          # tests/test_system.py's bar
ADAM_SHARE = 1e-4                            # test_torch_train.py's
# ROADMAP queue 3's training bars: (loss relative, gradient of a leaf's
# largest entry)
QAT_TOL = {"pt_dynamic": (1e-3, 5e-2), "ptoken_dynamic": (1e-3, 3e-2),
           "pt_static": (1e-3, 5e-2)}
FIRST_STEP = 1e-5        # none: the first step's loss, CE, gradient norm
WHOLE_LEAF = 2e-6        # a leaf held whole: one step's gradient vs tp = 1


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def flat(tree, prefix=""):
    """{"/"-path: f32 array} of a nested dict / list tree."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}/{k}" if prefix else k))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(flat(v, f"{prefix}/{i}"))
        return out
    if isinstance(tree, torch.Tensor):
        tree = tree.detach().numpy()
    return {prefix: np.asarray(tree, dtype=np.float32)}


def batches(vocab: int):
    pipe = Pipeline(SyntheticCorpus(vocab, seed=0), batch=B, seq_len=S,
                    seed=0)
    return [pipe.get_batch(i) for i in range(STEPS)]


def lr_sum(steps: int = STEPS) -> float:
    """The learning rates over steps 1..``steps`` (warmup 10)."""
    return sum(1e-3 * min(t, 10) / 10 for t in range(1, steps + 1))


def reference(japi, jp, tcfg, tb, qat: bool = True):
    """JAX's six steps under ``none`` (metrics a step, final parameters)
    and, with ``qat``, the port's pt_static scales (plain numpy) and JAX's
    first-step (loss, first moment) under each quantized mode."""
    run = JRun(model=japi.cfg, quant=JQ(), seq_len=S, global_batch=B,
               lr=1e-3, train_steps=12, warmup_steps=10)
    opt = JT.make_optimizer(run)
    step = jax.jit(JT.make_train_step(japi, run, opt))
    p, s = jp, opt.init(jp)
    metrics = []
    for b in tb:
        p, s, m = step(p, s, jax.tree.map(jnp.asarray, b))
        metrics.append({k: float(v) for k, v in m.items()})
    if not qat:
        return dict(metrics=metrics, params=np_tree(p))
    api = build(tcfg, "cpu")
    tp0 = convert.params_from_numpy(np_tree(jp)).tree()
    ts, _ = calibrate(api, tp0, [{k: torch.from_numpy(np.array(v))
                                  for k, v in b.items()} for b in tb[:2]],
                      QuantConfig(mode="pt_static"))

    def to_plain(t):
        if isinstance(t, dict):
            return {k: to_plain(v) for k, v in t.items()}
        return {"scale": t.scale.numpy(), "zero": t.zero.numpy()}

    def to_jax(d):
        if set(d) == {"scale", "zero"}:
            return JQU.SiteScale(scale=jnp.asarray(d["scale"]),
                                 zero=jnp.asarray(d["zero"]))
        return {k: to_jax(v) for k, v in d.items()}
    plain = to_plain(ts)
    js = to_jax(plain)
    jb = jax.tree.map(jnp.asarray, tb[0])

    def vg(mode):
        return jax.value_and_grad(lambda q: japi.loss_fn(
            q, jb, JQ(mode=mode), scales=js if mode == "pt_static" else None,
            remat=True)[0])
    qat = jax.jit(lambda q: {m: vg(m)(q) for m in QAT_TOL})(jp)
    return dict(metrics=metrics, params=np_tree(p), scales=plain,
                qat={m: (float(loss), first_moment(g))
                     for m, (loss, g) in qat.items()})


def family_batches(cfg, n: int, seed: int, rows: int = B, seq: int = 24):
    """``n`` numpy batches of ``rows`` x ``seq`` tokens and labels for the
    port's config ``cfg`` (its JAX twin takes the same), with a VLM's
    ``patches`` or an encoder-decoder's ``frames`` (normal x 0.02, f32: the
    stub frontends' output), from ``RandomState(seed)``."""
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        t = rs.randint(0, cfg.vocab_size, (rows, seq + 1)).astype(np.int32)
        b = {"tokens": t[:, :-1], "labels": t[:, 1:]}
        extra = (("patches", cfg.vlm.num_patches) if cfg.vlm is not None
                 else ("frames", cfg.encdec.encoder_seq)
                 if cfg.encdec is not None else None)
        if extra is not None:
            b[extra[0]] = (rs.randn(rows, extra[1], cfg.d_model)
                           * 0.02).astype(np.float32)
        out.append(b)
    return out


def first_steps(japi, jp, batch, modes=("none",) + tuple(QAT_TOL),
                eager: bool = False):
    """JAX's first training step on one device from ``jp`` on ``batch``
    (a numpy batch), under each mode of ``modes``, in one jitted call
    (``eager``: without jit, whose quantizers the port's follow: jitted,
    XLA turns a range's divide by 255 into a multiply,
    test_torch_train.py::test_reference_quantizer_jit_and_eager_differ):
    {mode: {"loss", "ce", "grad_norm", "mu1"}}, ``mu1`` AdamW's first
    moment after the step (``first_moment``), the loss with remat as
    ``make_train_step`` takes it (one microbatch: the loss is the CE)."""
    jb = jax.tree.map(jnp.asarray, batch)

    def vg(mode):
        return jax.value_and_grad(lambda q: japi.loss_fn(
            q, jb, JQ(mode=mode), remat=True), has_aux=True)

    def all_modes(q):
        return {m: vg(m)(q) for m in modes}
    if eager:
        with jax.disable_jit():
            got = all_modes(jp)
    else:
        got = jax.jit(all_modes)(jp)
    out = {}
    for mode, ((loss, aux), g) in got.items():
        gn = np.sqrt(sum(float(np.sum(np.square(
            np.asarray(x, np.float64)))) for x in jax.tree_util.tree_leaves(
                g)))
        out[mode] = {"loss": float(loss), "ce": float(aux["ce"]),
                     "grad_norm": gn, "mu1": first_moment(g)}
    return out


def first_moment(g):
    """AdamW's first moment after one step from a gradient tree: 0.1 x the
    gradient clipped to global norm 1, as numpy."""
    g = np_tree(g)
    gn = np.sqrt(sum(float(np.sum(np.square(x.astype(np.float64))))
                     for x in jax.tree_util.tree_leaves(g)))
    return jax.tree.map(lambda x: np.float32(0.1) * x * np.float32(
        min(1.0, 1.0 / (gn + 1e-9))), g)


class _Rank:
    def __init__(self, rank, size):
        self.rank, self.size = rank, size


def cut(tree, cfg, rank: int, tp: int):
    """{path: array} of a whole numpy tree cut to tensor-parallel rank
    ``rank``'s part (``engine.shard_tree``)."""
    t = convert.params_from_numpy(np_tree(tree)).tree()
    return flat(shard_tree(t, cfg, _Rank(rank, tp)) if tp > 1 else t)


def assert_params_close(got, want, total_lr, what):
    """The resume bar for every element but at most ``ADAM_SHARE`` of the
    tree's, those within the summed learning rate (Adam's first update of
    an element whose gradient lies within the sides' rounding of zero is
    decided by its last bits; test_torch_data_parallel.py's bar)."""
    assert sorted(got) == sorted(want), what
    n_bad, worst_bad, worst = 0, 0.0, 0.0
    for path in want:
        err = np.abs(got[path] - want[path])
        bad = err > RESUME["atol"] + RESUME["rtol"] * np.abs(want[path])
        n_bad += int(bad.sum())
        if bad.any():
            worst_bad = max(worst_bad, float(err[bad].max()))
        worst = max(worst, float(err[~bad].max(initial=0.0)))
    print(f"{what}: max |got - want| {worst:.3g} within the bar; {n_bad} "
          f"past it by up to {worst_bad:.3g}")
    assert n_bad <= ADAM_SHARE * sum(a.size for a in want.values()), what
    assert worst_bad <= total_lr, what


def leafwise(got, want, whole, frac, what):
    """Every leaf of ``got`` within ``frac`` of the largest entry of the
    same leaf of ``whole`` (the whole model's; ``want`` may be a rank's
    part of it). Returns the worst ratio."""
    assert sorted(got) == sorted(want), what
    worst = 0.0
    for path in want:
        scale = float(np.abs(whole[path]).max())
        err = float(np.abs(got[path] - want[path]).max())
        if scale > 0:
            worst = max(worst, err / scale)
        assert err <= frac * scale, (what, path, err, scale)
    print(f"{what}: worst leaf |got - want| / its max {worst:.3g}")
    return worst
