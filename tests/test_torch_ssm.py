"""Port parity, the Mamba mixer (``repro_torch.models.ssm``) against the JAX
package's on the same weights (JAX's, carried across through
``models/convert.py``) and numpy inputs, in f32, at the Mamba widths of
``reduced(jamba-v0.1-52b)`` (d_model 64, inner 128, d_state 16, d_conv 4,
dt_rank 4).

Tolerances, measured on the CPU with JAX's function jitted (the tests
print what they measure: ``pytest -s``):

* ``_conv_full``: within 1e-6 (measured 2.4e-7: the four taps summed in
  another order).
* ``apply_mamba``'s output and final ``h``, and ``decode_mamba``'s: within
  1e-5 of the largest entry (measured up to 6.6e-7 under pt_dynamic,
  3.0e-7 under none). The
  port's scan associates the products as the reference's
  ``associative_scan`` does (``ssm.associative_scan``: the same odd/even
  recursion and combine, its sum one fused multiply-add as XLA forms it),
  bit for bit on the same terms; the terms themselves (the conv, ``exp``,
  the projections) round otherwise by ulps. The conv state is a copy of
  the inputs: within 1e-6.
* ``apply_mamba`` over S positions against S ``decode_mamba`` steps, both
  the port's: within 1e-5 of the largest entry (measured 3.6e-7; the
  same recurrence, the conv and the in-projection batched differently).
* ``groups``: each stacked forward keeps its pt_dynamic ranges and L_q at
  ``mamba_in`` and ``mamba_out``, equal to the rows run alone within 2e-6
  of the largest entry (measured 9.0e-8: the linears batch other rows)
  and L_q within 1e-5 relative.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import QuantConfig, get_config, reduced  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.configs import reduced as t_reduced  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402

QN = QuantConfig()
QD = QuantConfig(mode="pt_dynamic")
BAR = 1e-5


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def configs():
    return (reduced(get_config("jamba-v0.1-52b"), dtype="float32"),
            t_reduced(t_get_config("jamba-v0.1-52b"), dtype="float32"))


@pytest.fixture(scope="module")
def mamba():
    jcfg, tcfg = configs()
    jp = JS.mamba_init(jax.random.PRNGKey(3), jcfg)
    return jcfg, tcfg, jp, convert.params_from_numpy(np_tree(jp)).tree()


def _rel(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    err = float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))
    print(f"{what}: max |port - JAX| / max |JAX| {err:.2e}")
    return err


def test_dims_and_init_shapes_match_jax(mamba):
    jcfg, tcfg, jp, tp = mamba
    assert TS.dims(tcfg) == JS.dims(jcfg) == (128, 16, 4, 4)
    own = TS.mamba_init(torch.Generator().manual_seed(0), tcfg)
    for k, v in jp.items():
        assert tuple(own[k].shape) == v.shape, k
        assert str(own[k].dtype).split(".")[-1] == str(v.dtype), k
    # S4D-real A (log within an ulp of XLA's); dt_b is the inverse
    # softplus of dt in [0.001, 0.1]
    np.testing.assert_allclose(own["A_log"].numpy(), np.asarray(jp["A_log"]),
                               rtol=1.2e-7, atol=0)
    dt = torch.nn.functional.softplus(own["dt_b"])
    assert float(dt.min()) >= 0.001 * 0.999 and float(dt.max()) <= 0.1001


def test_conv_full_matches_jax():
    rs = np.random.RandomState(0)
    x = rs.randn(2, 11, 128).astype(np.float32)
    w = rs.randn(4, 128).astype(np.float32)
    b = rs.randn(128).astype(np.float32)
    want = JS._conv_full(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    got = TS._conv_full(torch.from_numpy(x), torch.from_numpy(w),
                        torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
    # causal: the first output sees x[0] only
    np.testing.assert_allclose(got[:, 0].numpy(), x[:, 0] * w[3] + b,
                               rtol=1e-6, atol=1e-6)


def _state(rs, batched, B=2):
    lead = (B,) if batched else ()
    return {"h": rs.randn(*lead, 128, 16).astype(np.float32) * 0.5,
            "conv": rs.randn(*lead, 3, 128).astype(np.float32)}


@pytest.mark.parametrize("state", ["none", "batch-free", "batched"])
def test_apply_mamba_matches_jax(mamba, state):
    """Output, final h and the conv state, with no initial state, with a
    batch-free (the cushion's) and with a batched one."""
    jcfg, tcfg, jp, tp = mamba
    rs = np.random.RandomState(1)
    x = rs.randn(2, 70, 64).astype(np.float32)       # > one scan chunk
    st = None if state == "none" else _state(rs, state == "batched")
    jout, jst = jax.jit(lambda p, x, s: JS.apply_mamba(
        p, x, jcfg, QN, None, None, init_state=s, return_state=True))(
            jp, jnp.asarray(x), st)
    tst = None if st is None else {k: torch.from_numpy(v)
                                   for k, v in st.items()}
    tout, tnew = TS.apply_mamba(tp, torch.from_numpy(x), tcfg, QN, None,
                                None, init_state=tst, return_state=True)
    assert _rel(tout.numpy(), jout, f"[{state}] out") <= BAR
    assert _rel(tnew["h"].numpy(), jst["h"], f"[{state}] h") <= BAR
    np.testing.assert_allclose(tnew["conv"].numpy(), np.asarray(jst["conv"]),
                               rtol=0, atol=1e-6)
    assert tnew["h"].dtype == torch.float32
    # without return_state: the same output
    t2 = TS.apply_mamba(tp, torch.from_numpy(x), tcfg, QN, None, None,
                        init_state=tst)
    np.testing.assert_array_equal(t2.numpy(), tout.numpy())


def test_apply_mamba_conv_state_is_zero_padded_as_jax(mamba):
    """Fewer positions than d_conv - 1: the returned conv state pads the
    inputs with zeros, not with the initial state's rows (the reference's
    rule)."""
    jcfg, tcfg, jp, tp = mamba
    rs = np.random.RandomState(2)
    x = rs.randn(1, 2, 64).astype(np.float32)
    st = _state(rs, False)
    _, jst = JS.apply_mamba(jp, jnp.asarray(x), jcfg, QN, None, None,
                            init_state=st, return_state=True)
    _, tst = TS.apply_mamba(tp, torch.from_numpy(x), tcfg, QN, None, None,
                            init_state={k: torch.from_numpy(v)
                                        for k, v in st.items()},
                            return_state=True)
    np.testing.assert_allclose(tst["conv"].numpy(), np.asarray(jst["conv"]),
                               rtol=0, atol=1e-6)
    assert not tst["conv"][0, 0].any()


@pytest.mark.parametrize("mode", ["none", "pt_dynamic"])
def test_decode_mamba_steps_match_jax(mamba, mode):
    """Five single-token steps from a batched state, against JAX's."""
    jcfg, tcfg, jp, tp = mamba
    qcfg = QN if mode == "none" else QD
    rs = np.random.RandomState(3)
    st = _state(rs, True)
    jst, tst = st, {k: torch.from_numpy(v) for k, v in st.items()}
    jdec = jax.jit(lambda p, x, s: JS.decode_mamba(p, x, s, jcfg, qcfg,
                                                   None))
    for i in range(5):
        x = rs.randn(2, 1, 64).astype(np.float32)
        jout, jst = jdec(jp, jnp.asarray(x), jst)
        tout, tst = TS.decode_mamba(tp, torch.from_numpy(x), tst, tcfg, qcfg,
                                    None)
        assert _rel(tout.numpy(), jout, f"[{mode}] step {i} out") <= BAR
        assert _rel(tst["h"].numpy(), jst["h"], f"[{mode}] step {i} h") \
            <= BAR
        np.testing.assert_allclose(tst["conv"].numpy(),
                                   np.asarray(jst["conv"]), rtol=0,
                                   atol=1e-6)


def test_apply_mamba_equals_decode_steps(mamba):
    """The scan over S positions = S recurrent steps from the same state."""
    _, tcfg, _, tp = mamba
    rs = np.random.RandomState(4)
    x = torch.from_numpy(rs.randn(2, 9, 64).astype(np.float32))
    st = {k: torch.from_numpy(v) for k, v in _state(rs, True).items()}
    full, fst = TS.apply_mamba(tp, x, tcfg, QN, None, None, init_state=st,
                               return_state=True)
    cur, outs = st, []
    for t in range(9):
        o, cur = TS.decode_mamba(tp, x[:, t:t + 1], cur, tcfg, QN, None)
        outs.append(o)
    assert _rel(torch.cat(outs, 1).numpy(), full.numpy(), "scan vs steps") \
        <= BAR
    assert _rel(cur["h"].numpy(), fst["h"].numpy(), "scan vs steps h") <= BAR
    np.testing.assert_allclose(cur["conv"].numpy(), fst["conv"].numpy(),
                               rtol=0, atol=1e-6)


def test_groups_keep_per_group_ranges(mamba):
    """groups=3 stacked forwards under pt_dynamic: each keeps its own
    dynamic ranges and L_q at mamba_in and mamba_out."""
    _, tcfg, _, tp = mamba
    xs = [torch.from_numpy(np.random.RandomState(i).randn(1, 10, 64)
                           .astype(np.float32) * (1 + 3 * i))
          for i in range(3)]
    taps = {}
    y = TS.apply_mamba(tp, torch.cat(xs), tcfg, QD, None, taps, groups=3)
    merged = TS.apply_mamba(tp, torch.cat(xs), tcfg, QD, None, None)
    assert float((merged - y).abs().max()) > 1e-4     # ranges do differ
    for i, x in enumerate(xs):
        t1 = {}
        y1 = TS.apply_mamba(tp, x, tcfg, QD, None, t1)
        assert _rel(y[i:i + 1].numpy(), y1.numpy(), f"group {i}") <= 2e-6
        for site in TS.SITES:
            np.testing.assert_allclose(float(taps[site]["qerr"][i]),
                                       float(t1[site]["qerr"]), rtol=1e-5)


def test_autograd_runs_through_the_scan(mamba):
    """The tuning differentiates through the loop: the gradient of the
    output with respect to the initial state is that of the recurrence."""
    _, tcfg, _, tp = mamba
    rs = np.random.RandomState(5)
    x = torch.from_numpy(rs.randn(1, 6, 64).astype(np.float32))
    h0 = torch.from_numpy(_state(rs, False)["h"]).requires_grad_()
    out = TS.apply_mamba(tp, x, tcfg, QN, None, None, init_state={"h": h0})
    (g,) = torch.autograd.grad(out.square().sum(), h0)
    assert g.shape == h0.shape and bool(torch.isfinite(g).all())
    assert float(g.abs().max()) > 0


@pytest.mark.parametrize("S", [1, 2, 3, 7, 24, 33, 70, 257])
def test_associative_scan_is_jax_bit_for_bit(S):
    """``ssm.associative_scan`` on the reference's combine gives
    ``jax.lax.associative_scan``'s (jitted) a and h bit for bit, at odd and
    even lengths (a's subnormal products aside, which XLA flushes to zero);
    the position-by-position recurrence does not (the products associate
    otherwise: up to ~1e-6 apart here)."""
    rs = np.random.RandomState(S)
    a = np.exp(-rs.rand(2, S, 8, 4).astype(np.float32))
    b = rs.randn(2, S, 8, 4).astype(np.float32)

    def combine(x, y):
        (a1, b1), (a2, b2) = x, y
        return a2 * a1, a2 * b1 + b2
    ja, jh = jax.jit(lambda a, b: jax.lax.associative_scan(
        combine, (a, b), axis=1))(a, b)
    ta, th = TS.associative_scan(torch.from_numpy(a), torch.from_numpy(b))
    # XLA on the CPU flushes subnormal results to zero, PyTorch keeps them
    # (long products of a reach them): compare a with those flushed
    tiny = np.finfo(np.float32).tiny
    ta = np.where(np.abs(ta.numpy()) < tiny, 0.0, ta.numpy())
    np.testing.assert_array_equal(ta, np.asarray(ja))
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    h, seq = torch.zeros(2, 8, 4), []
    for t in range(S):
        h = torch.addcmul(torch.from_numpy(b[:, t]),
                          torch.from_numpy(a[:, t]), h)
        seq.append(h)
    gap = float(np.abs(torch.stack(seq, 1).numpy() - np.asarray(jh)).max())
    print(f"S={S}: the sequential recurrence {gap:.3g} from JAX's scan")
    assert gap <= 1e-5
