"""Port parity, prefix tuning (paper §4.2): ``loss_fn``, the activation-
range penalty, the gradient into the cushion, one AdamW update, six
``prefix_tune`` steps and the tuning loop's host-sync bound, against the
JAX package on JAX's paper_tiny params and cushion (converted through
numpy) and JAX's batches; and ``flash_attention_bwd_plain`` (the plain
version of the card's backward kernel) against autograd of
``flash_attention_plain`` and ``jax.grad`` of the reference's
``flash_attention_jnp``.

Tolerances, measured on the CPU (the tests print what they measure:
``pytest -s``) and stated per quantization mode of the tuning loss:

* ``none`` (no fake quant; L_q still logged): CE 1e-6 relative, L_q and
  the range penalty 1e-5; the gradient into the cushion within 1e-5 of its
  largest entry (measured 1.9e-6); six tuning steps: every logged metric
  1e-5 relative (measured 1.6e-6) and the tuned cushion within 1e-6 of the
  reference's per element (measured 2.4e-7, against a move of 5.8e-3):
  the two autograds reduce in other orders, so the cushion is not
  bit-identical (ROADMAP queue 1 item 2), but it is this close.
* ``pt_dynamic`` (the launcher's default): one ulp at a tensor's extreme,
  or a code at a rounding tie, moves a per-tensor range and so every code
  of the tensor. The reference disagrees with itself there: on batch 0
  its jitted and its eager (``jax.disable_jit``) loss differ by 2.7e-4
  (CE), 6.9e-3 (L_q) and 4.6e-3 (range). So CE 1e-3, L_q and range 1e-2;
  the gradient within 1e-4 of its largest entry and 2e-3 in norm; after
  six steps the logs within 5e-2 relative (measured 1.6e-2) and the mean
  |port - reference| of the cushion below a quarter of its mean move
  (measured 0.13: Adam moves an element ~lr a step whatever the size of
  its gradient, so an element whose tiny gradient changes sign parts).

One AdamW step: 1e-6 relative (f32 leaves) and one bf16 ulp (bf16
leaves), the frozen leaf bit-identical. The attention backward: 1e-5 of
the largest gradient entry against autograd and against jax.grad, dead
prefix rows exactly zero.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small shapes: one intra-op thread, so parallel test workers do not
# oversubscribe the cores
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import CushionConfig, QuantConfig, get_config  # noqa: E402
from repro.core import cushioncache as JCC  # noqa: E402
from repro.core import outliers as JOUT  # noqa: E402
from repro.models import common as JC  # noqa: E402
from repro.models.registry import build as j_build  # noqa: E402
from repro.optim import adamw as JA  # noqa: E402
from repro.train.trainer import eval_ppl as j_eval_ppl  # noqa: E402
from repro_torch.train.trainer import eval_ppl  # noqa: E402
from repro_torch import monitoring as MON  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.core import cushioncache as TCC  # noqa: E402
from repro_torch.core import outliers as TOUT  # noqa: E402
from repro_torch.core import quantization as TQ  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_bwd_plain, flash_attention_plain)
from repro_torch.models import convert  # noqa: E402
from repro_torch.optim import adamw as TA  # noqa: E402
from repro_torch.models.registry import build  # noqa: E402

QD = QuantConfig(mode="pt_dynamic")
QN = QuantConfig(mode="none")
QMODES = {"none": QN, "pt_dynamic": QD}
LAM = 0.1
# mode: (CE, L_q and range, gradient (of its max), gradient norm) bars
LOSS_TOL = {"none": (1e-6, 1e-5, 1e-5, 1e-5),
            "pt_dynamic": (1e-3, 1e-2, 1e-4, 2e-3)}


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def to_torch(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


@pytest.fixture(scope="module")
def tiny():
    japi = j_build(get_config("paper_tiny"))
    jp = japi.init_params(jax.random.PRNGKey(0))
    jcush = japi.extract_cushion(jp, jnp.asarray([1, 2, 3], jnp.int32),
                                 None, QN)
    api = build(t_get_config("paper_tiny"), "cpu")
    tp = convert.params_from_numpy(np_tree(jp)).tree()
    batches = [japi.make_batch(jax.random.PRNGKey(3000 + i), 2, 24)
               for i in range(12)]
    return japi, jp, jcush, api, tp, batches


def _jloss(japi, jp, batch, qcfg):
    def f(cush):
        _, aux = japi.loss_fn(jp, batch, qcfg, cushion=cush, collect=True,
                              remat=False)
        reg = JOUT.activation_range_penalty(aux["taps"])
        return aux["ce"] + LAM * reg, (aux["ce"], aux["qerr"], reg)
    return f


def _tloss(api, tp, batch, qcfg):
    def f(cush):
        _, aux = api.loss_fn(tp, batch, qcfg, cushion=cush, collect=True)
        reg = TOUT.activation_range_penalty(aux["taps"])
        return aux["ce"] + LAM * reg, (aux["ce"], aux["qerr"], reg)
    return f


@pytest.mark.parametrize("mode", list(QMODES))
def test_loss_and_range_penalty_match_jax(tiny, mode):
    japi, jp, jcush, api, tp, batches = tiny
    qcfg, (ce_tol, q_tol, _, _) = QMODES[mode], LOSS_TOL[mode]
    jl, (jce, jq, jr) = jax.jit(_jloss(japi, jp, batches[0], qcfg))(jcush)
    with torch.no_grad():
        tl, (tce, tq, tr) = _tloss(api, tp, to_torch(batches[0]), qcfg)(
            to_torch(jcush))
    print(f"[{mode}] relative |port - JAX|: CE "
          f"{abs(float(tce) / float(jce) - 1):.2e}, L_q "
          f"{abs(float(tq) / float(jq) - 1):.2e}, range "
          f"{abs(float(tr) / float(jr) - 1):.2e}")
    np.testing.assert_allclose(float(tce), float(jce), rtol=ce_tol)
    np.testing.assert_allclose(float(tq), float(jq), rtol=q_tol)
    np.testing.assert_allclose(float(tr), float(jr), rtol=q_tol)
    np.testing.assert_allclose(float(tl), float(jl), rtol=q_tol)
    # lam > 0 adds λ·L_q to the loss, as in the reference
    loss, aux = api.loss_fn(tp, to_torch(batches[0]), QD,
                            cushion=to_torch(jcush), lam=0.5)
    np.testing.assert_allclose(float(loss),
                               float(aux["ce"] + 0.5 * aux["qerr"]),
                               rtol=1e-6)


@pytest.mark.parametrize("mode", list(QMODES))
def test_grad_into_cushion_matches_jax(tiny, mode):
    """∂L/∂cushion of L = CE + λ·range: the gradient flows through every
    layer's attention into the cushion KV (and, under pt_dynamic, through
    the straight-through quantizers)."""
    japi, jp, jcush, api, tp, batches = tiny
    qcfg, (_, _, g_tol, n_tol) = QMODES[mode], LOSS_TOL[mode]
    jg, _ = jax.jit(jax.grad(_jloss(japi, jp, batches[1], qcfg),
                             has_aux=True))(jcush)
    cush = jax.tree.map(lambda a: a.requires_grad_(), to_torch(jcush))
    loss, _ = _tloss(api, tp, to_torch(batches[1]), qcfg)(cush)
    loss.backward()
    for k in ("k", "v"):
        got = cush["kv"][k].grad.numpy()
        want = np.asarray(jg["kv"][k])
        assert np.abs(want).max() > 0
        print(f"[{mode}] d/d{k}: max |port - JAX| / max |JAX| "
              f"{np.abs(got - want).max() / np.abs(want).max():.2e}, norm "
              f"ratio - 1 {np.linalg.norm(got) / np.linalg.norm(want) - 1:.2e}")
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=g_tol * np.abs(want).max())
        assert abs(np.linalg.norm(got) / np.linalg.norm(want) - 1) < n_tol


def test_pt_dynamic_reference_disagrees_with_itself(tiny):
    """Why the pt_dynamic bars are looser: the reference's jitted loss and
    its eager one (jax.disable_jit) round differently (XLA turns a divide
    by 255 into a multiply), and on batch 0 the one-ulp differences move
    per-tensor ranges. The port, which divides, sits within the stated
    bars of both."""
    japi, jp, jcush, api, tp, batches = tiny
    f = _jloss(japi, jp, batches[0], QD)
    jit = jax.jit(f)(jcush)[1]
    with jax.disable_jit():
        eager = f(jcush)[1]
    with torch.no_grad():
        port = _tloss(api, tp, to_torch(batches[0]), QD)(to_torch(jcush))[1]
    spread = [abs(float(a) / float(b) - 1) for a, b in zip(jit, eager)]
    print("reference jit vs eager (CE, L_q, range):",
          ["%.2e" % x for x in spread])
    assert max(spread) > 1e-4          # the reference is at a rounding edge
    ce_tol, q_tol, _, _ = LOSS_TOL["pt_dynamic"]
    for ref in (jit, eager):
        for (p_, r_), tol in zip(zip(port, ref), (ce_tol, q_tol, q_tol)):
            np.testing.assert_allclose(float(p_), float(r_), rtol=tol)


def test_amax_ties_split_the_gradient_as_jax():
    """site_stats' amin / amax and the penalty's max(amax, -amin) split a
    tie's gradient evenly, as jnp.max / jnp.maximum do."""
    x = np.zeros((1, 3, 4), np.float32)
    x[0, 0, 1] = x[0, 2, 3] = 2.0           # tied maxima
    x[0, 1, 0] = -2.0                       # -amin ties amax too
    x[0, 1, 2] = 0.5

    def jpen(a):
        taps = {"layers": {"qkv": {"amin": jnp.min(a), "amax": jnp.max(a)}}}
        return JOUT.activation_range_penalty(taps)

    jg = np.asarray(jax.grad(jpen)(jnp.asarray(x)))
    t = torch.from_numpy(x.copy()).requires_grad_()
    TOUT.activation_range_penalty(
        {"layers": {"qkv": TQ.site_stats(t)}}).backward()
    np.testing.assert_array_equal(t.grad.numpy(), jg)
    assert np.count_nonzero(jg) == 3


def test_adamw_update_matches_jax():
    """Two AdamW steps on a tree with an f32 and a bf16 trainable leaf and
    a frozen one: the global-norm clip (active: the gradients' norm is
    above 1), f32 moments, the update cast back to each leaf's dtype, the
    frozen leaf passed through bit for bit."""
    rs = np.random.RandomState(0)
    p32 = rs.randn(3, 5).astype(np.float32)
    p16 = rs.randn(4, 2).astype(np.float32)
    ph = rs.randn(2, 2).astype(np.float32)
    grads = [{"kv": {"k": rs.randn(3, 5).astype(np.float32) * 3,
                     "v": rs.randn(4, 2).astype(np.float32) * 3},
              "state": {"h": rs.randn(2, 2).astype(np.float32)}}
             for _ in range(2)]
    jparams = {"kv": {"k": jnp.asarray(p32),
                      "v": jnp.asarray(p16).astype(jnp.bfloat16)},
               "state": {"h": jnp.asarray(ph)}}
    tparams = {"kv": {"k": torch.from_numpy(p32.copy()),
                      "v": torch.from_numpy(p16.copy()).to(torch.bfloat16)},
               "state": {"h": torch.from_numpy(ph.copy())}}
    jopt = JA.AdamW(lr=JA.constant_lr(1e-2), weight_decay=0.1,
                    frozen=("state",))
    topt = TA.AdamW(lr=TA.constant_lr(1e-2), weight_decay=0.1,
                    frozen=("state",))
    js, ts = jopt.init(jparams), topt.init(tparams)
    for g in grads:
        jparams, js, jm = jopt.update(jax.tree.map(jnp.asarray, g), js,
                                      jparams)
        tparams, ts, tm = topt.update(
            jax.tree.map(lambda a: torch.from_numpy(a.copy()), g), ts,
            tparams)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
    assert float(tm["grad_norm"]) > 1.0
    np.testing.assert_allclose(tparams["kv"]["k"].numpy(),
                               np.asarray(jparams["kv"]["k"]), rtol=1e-6)
    assert tparams["kv"]["v"].dtype == torch.bfloat16
    jv = np.asarray(jparams["kv"]["v"].astype(jnp.float32))
    np.testing.assert_allclose(tparams["kv"]["v"].float().numpy(), jv,
                               rtol=2.0 ** -8, atol=0)
    np.testing.assert_array_equal(tparams["state"]["h"].numpy(), ph)
    for k in ("k", "v"):
        np.testing.assert_allclose(ts.mu["kv"][k].numpy(),
                                   np.asarray(js.mu["kv"][k]), rtol=1e-6)
        np.testing.assert_allclose(ts.nu["kv"][k].numpy(),
                                   np.asarray(js.nu["kv"][k]), rtol=1e-6)
    assert int(ts.step) == int(js.step) == 2
    # the schedules
    for step in (0, 3, 10, 40):
        s_t = torch.tensor(step, dtype=torch.int32)
        np.testing.assert_allclose(
            float(TA.cosine_lr(1e-3, 5, 30)(s_t)),
            float(JA.cosine_lr(1e-3, 5, 30)(jnp.int32(step))), rtol=1e-6)


@pytest.mark.parametrize("mode", list(QMODES))
def test_prefix_tune_matches_jax(tiny, mode):
    """Six prefix_tune steps from JAX's cushion on JAX's batches: the log
    and the tuned cushion within the measured bars of the module
    docstring, and the cushion moved."""
    japi, jp, jcush, api, tp, batches = tiny
    qcfg = QMODES[mode]
    ccfg = CushionConfig(tune_steps=6, tune_lr=1e-3, lam=LAM, log_every=3)
    jtr = JCC.prefix_tune(japi, jp, jcush, iter(batches), qcfg, ccfg,
                          verbose=False)
    cush0 = to_torch(jcush)
    ttr = TCC.prefix_tune(api, tp, cush0, (to_torch(b) for b in batches),
                          qcfg, ccfg, verbose=False)
    assert [r["step"] for r in ttr.log] == list(range(6))
    log_tol = 1e-5 if mode == "none" else 5e-2
    print(f"[{mode}] six steps: logs max relative |port - JAX| " + str(max(
        abs(tr_[key] / jr_[key] - 1) for tr_, jr_ in zip(ttr.log, jtr.log)
        for key in ("loss", "ce", "range", "qerr", "gnorm"))))
    for tr_, jr_ in zip(ttr.log, jtr.log):
        for key in ("loss", "ce", "range", "qerr", "gnorm"):
            np.testing.assert_allclose(tr_[key], jr_[key], rtol=log_tol,
                                       err_msg=key)
    for k in ("k", "v"):
        got = ttr.cushion["kv"][k].numpy()
        want = np.asarray(jtr.cushion["kv"][k])
        move = np.abs(want - np.asarray(jcush["kv"][k]))
        print(f"[{mode}] tuned {k}: max |port - JAX| "
              f"{np.abs(got - want).max():.2e}, mean / mean move "
              f"{np.abs(got - want).mean() / move.mean():.3f}, max move "
              f"{move.max():.2e}")
        assert move.max() > 1e-3, move.max()
        if mode == "none":
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        else:
            assert np.abs(got - want).mean() < 0.25 * move.mean()
        assert not torch.equal(ttr.cushion["kv"][k], cush0["kv"][k])


def test_tune_host_syncs_bounded(tiny):
    """The metrics drain every log_every steps: 12 steps at log_every=4
    make at most 12 / 4 + 1 transfers and log all 12 steps in order."""
    japi, jp, jcush, api, tp, batches = tiny
    ccfg = CushionConfig(tune_steps=12, tune_lr=1e-3, lam=LAM, log_every=4)
    with MON.count_host_syncs() as c:
        tr = TCC.prefix_tune(api, tp, to_torch(jcush),
                             (to_torch(b) for b in batches), QD, ccfg,
                             verbose=False)
    assert c.count <= 12 // 4 + 1, c.count
    assert [r["step"] for r in tr.log] == list(range(12))
    assert all(np.isfinite(r["loss"]) for r in tr.log)
    assert tr.cushion["kv"]["k"].dtype == torch.float32


def _attn_inputs(hd, B=2, H=4, Kh=2, S=20, m=5, seed=0):
    rs = np.random.RandomState(seed)
    q = rs.randn(B, H, S, hd).astype(np.float32)
    k = rs.randn(B, Kh, m + S, hd).astype(np.float32)
    v = rs.randn(B, Kh, m + S, hd).astype(np.float32)
    do = rs.randn(B, H, S, hd).astype(np.float32)
    return q, k, v, do


@pytest.mark.parametrize("hd", [32, 64, 80])
@pytest.mark.parametrize("live", [5, 3, 0])
def test_flash_attention_bwd_plain_matches_autograd_and_jax(hd, live):
    """GQA (H = 4, Kh = 2) behind a 5-row prefix whose rows [live, 5) are
    dead: the plain backward against autograd of the plain forward and
    against jax.grad of the reference's flash_attention_jnp; a dead row's
    dK and dV are exactly zero."""
    m = 5
    q, k, v, do = _attn_inputs(hd, m=m)
    tq, tk, tv = (torch.from_numpy(a.copy()).requires_grad_()
                  for a in (q, k, v))
    o, lse = flash_attention_plain(tq, tk, tv, prefix_len=m,
                                   prefix_live=live, return_lse=True)
    (o * torch.from_numpy(do)).sum().backward()
    dq, dk, dv = flash_attention_bwd_plain(
        tq.detach(), tk.detach(), tv.detach(), o.detach(), lse.detach(),
        torch.from_numpy(do), m, live)
    for got, want in ((dq, tq.grad), (dk, tk.grad), (dv, tv.grad)):
        tol = 1e-5 * float(want.abs().max())
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=tol)
    assert not dk[:, :, live:m].any() and not dv[:, :, live:m].any()

    # the reference: (B, S, H, hd) layout, prefix_valid = arange(m) < live
    def jf(q_, k_, v_):
        out = JC.flash_attention_jnp(
            q_, k_, v_, None, causal=True, prefix_len=m,
            prefix_valid=jnp.arange(m) < live)
        return jnp.sum(out * jnp.asarray(do.transpose(0, 2, 1, 3)))

    jq, jk, jv = (jnp.asarray(a.transpose(0, 2, 1, 3)) for a in (q, k, v))
    jg = jax.grad(jf, argnums=(0, 1, 2))(jq, jk, jv)
    for got, want in zip((dq, dk, dv), jg):
        want = np.asarray(want).transpose(0, 2, 1, 3)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())


def test_outlier_stats_and_eval_ppl_match_jax(tiny):
    """The analysis numbers of tune.py's report: magnitude_stats on a
    tensor, last_block_input_stats and per_layer_top_stats of a forward
    under the cushion (rtol 1e-5), and eval_ppl (rtol 1e-5)."""
    japi, jp, jcush, api, tp, batches = tiny
    x = np.random.RandomState(3).randn(2, 9, 16).astype(np.float32)
    js = JOUT.magnitude_stats(jnp.asarray(x), n_skip=2)
    ts = TOUT.magnitude_stats(torch.from_numpy(x), n_skip=2)
    for k in ("top1", "top2", "top3", "top10pct", "median"):
        np.testing.assert_allclose(float(ts[k]), float(js[k]), rtol=1e-6,
                                   err_msg=k)
    cush = to_torch(jcush)
    b = to_torch(batches[2])
    jl = JOUT.last_block_input_stats(japi, jp, batches[2], QN, cushion=jcush)
    tl = TOUT.last_block_input_stats(api, tp, b, QN, cushion=cush)
    for k in jl:
        np.testing.assert_allclose(tl[k], jl[k], rtol=1e-5, err_msg=k)
    jrows = JOUT.per_layer_top_stats(japi, jp, batches[2], QN, cushion=jcush)
    trows = TOUT.per_layer_top_stats(api, tp, b, QN, cushion=cush)
    assert [r["layer"] for r in trows] == [r["layer"] for r in jrows]
    for tr_, jr_ in zip(trows, jrows):
        for k in ("top1", "top2", "top3", "median"):
            np.testing.assert_allclose(tr_[k], jr_[k], rtol=1e-5)
    np.testing.assert_allclose(
        eval_ppl(api, tp, [to_torch(x_) for x_ in batches[:2]], QN,
                 cushion=cush),
        j_eval_ppl(japi, jp, batches[:2], QN, cushion=jcush), rtol=1e-5)
