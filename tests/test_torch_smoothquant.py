"""Port parity, SmoothQuant's fold (``repro_torch.core.smoothquant``)
against the JAX package's on ``paper_tiny``: the same weights and the same
calibration statistics (JAX's, carried across through numpy).

Tolerances. The factors ``a ** alpha / w ** (1 - alpha)`` are not
bit-identical: the two libraries' ``pow`` round one f32 ulp apart in 2-5%
of the channels, so a factor (a quotient of two powers) is within two ulp
of JAX's (measured 2). Given JAX's factors, the
fold is bit-identical to JAX's on every leaf (each step is one rounded
multiply, divide or max). With its own factors, every folded leaf is
within 8 f32 ulp of JAX's (measured 6: a leaf takes up to two factors).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small shapes: one intra-op thread, so parallel test workers do not
# oversubscribe the cores
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import QuantConfig, get_config, reduced  # noqa: E402
from repro.core import calibration as JCal  # noqa: E402
from repro.core import smoothquant as JSQ  # noqa: E402
from repro.models.registry import build as j_build  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.configs import reduced as t_reduced  # noqa: E402
from repro_torch.core import calibration as TCal  # noqa: E402
from repro_torch.core import smoothquant as TSQ  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models.registry import build  # noqa: E402

QS = QuantConfig(mode="pt_static")


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, tree


@pytest.fixture(scope="module")
def tiny():
    cfg = get_config("paper_tiny")
    japi = j_build(cfg)
    jp = japi.init_params(jax.random.PRNGKey(0))
    # a hot input channel for the mlp, as tests/test_substrate.py plants
    jp["layers"]["ln2"]["g"] = jp["layers"]["ln2"]["g"].at[:, 3].set(50.0)
    batches = [japi.make_batch(jax.random.PRNGKey(i), 2, 32)
               for i in range(2)]
    _, jstats = JCal.calibrate(japi, jp, batches, QS)
    return dict(cfg=cfg, tcfg=t_get_config("paper_tiny"), japi=japi,
                api=build(t_get_config("paper_tiny"), "cpu"), jp=jp,
                tp=convert.params_from_numpy(np_tree(jp)), jstats=jstats,
                batches=batches)


def _fold_both(s, alpha):
    jsm = JSQ.apply_smoothquant(s["jp"], s["jstats"], s["cfg"], alpha=alpha)
    stats = convert.cushion_from_numpy(np_tree(s["jstats"]))
    tsm = TSQ.apply_smoothquant(s["tp"], stats, s["tcfg"], alpha=alpha)
    got = dict(_leaves(tsm.tree()))
    want = {k: convert.tensor_from_numpy(v)
            for k, v in _leaves(np_tree(jsm))}
    assert set(got) == set(want)
    for path, w in want.items():
        assert got[path].dtype == w.dtype, path
    return got, want


def _jax_factors(a, w, alpha):
    return torch.from_numpy(np.asarray(JSQ._factors(
        jnp.asarray(a.numpy()), jnp.asarray(w.numpy()), alpha)))


@pytest.mark.parametrize("alpha", [0.5, 0.8])
def test_fold_matches_jax(tiny, alpha, monkeypatch):
    s = tiny
    # the factors: within two ulp
    ls = {k: np_tree(v)["absmax_ch"] for k, v in
          s["jstats"]["layers"].items()}
    w_up = np.asarray(s["jp"]["layers"]["mlp"]["w_up"])
    for l in range(s["cfg"].n_layers):
        jf = _jax_factors(torch.from_numpy(ls["mlp_in"][l]),
                          TSQ._w_absmax_in(torch.from_numpy(w_up[l])), alpha)
        tf = TSQ._factors(torch.from_numpy(ls["mlp_in"][l]),
                          TSQ._w_absmax_in(torch.from_numpy(w_up[l])), alpha)
        ulp = np.spacing(jf.numpy())
        assert np.all(np.abs(tf.numpy() - jf.numpy()) <= 2 * ulp), l
    # the port's own fold: within 8 ulp of every leaf
    got, want = _fold_both(s, alpha)
    worst = 0.0
    for path, w in want.items():
        d = (got[path] - w).abs().numpy() / np.spacing(w.abs().numpy())
        worst = max(worst, float(d.max()))
    print(f"alpha {alpha}: own factors, largest leaf difference "
          f"{worst:.0f} ulp")
    assert worst <= 8, worst
    # given JAX's factors: bit-identical
    monkeypatch.setattr(TSQ, "_factors", _jax_factors)
    got, want = _fold_both(s, alpha)
    for path, w in want.items():
        assert torch.equal(got[path], w), path
    # the fold changed something, and the input tree is left as it was
    assert not torch.equal(got[("layers", "ln2", "g")],
                           s["tp"].tree()["layers"]["ln2"]["g"])
    assert torch.equal(s["tp"].tree()["layers"]["ln2"]["g"],
                       convert.tensor_from_numpy(
                           np.asarray(s["jp"]["layers"]["ln2"]["g"])))


def test_fold_keeps_the_function(tiny):
    """The fold is a reparameterisation: the fp logits barely move."""
    s = tiny
    batch = {"tokens": torch.from_numpy(np.asarray(
        s["batches"][0]["tokens"]))}
    _, stats = TCal.calibrate(s["api"], s["tp"], [batch], QS)
    sm = TSQ.apply_smoothquant(s["tp"], stats, s["tcfg"])
    l0, _ = s["api"].forward(s["tp"], batch, QuantConfig())
    l1, _ = s["api"].forward(sm, batch, QuantConfig())
    np.testing.assert_allclose(l1.numpy(), l0.numpy(), rtol=1e-3, atol=1e-3)


def test_smoothquant_flattens_activations(tiny):
    """``tests/test_substrate.py``'s check on the port: after the fold the
    largest mlp_in channel max falls."""
    s = tiny
    batches = [{"tokens": torch.from_numpy(np.asarray(b["tokens"]))}
               for b in s["batches"]]
    _, stats = TCal.calibrate(s["api"], s["tp"], batches, QS)
    before = stats["layers"]["mlp_in"]["absmax_ch"].numpy()
    sm = TSQ.apply_smoothquant(s["tp"], stats, s["tcfg"], alpha=0.8)
    _, stats2 = TCal.calibrate(s["api"], sm, batches, QS)
    after = stats2["layers"]["mlp_in"]["absmax_ch"].numpy()
    assert after.max() < before.max()


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "arctic-480b"])
def test_moe_raises_as_jax(arch):
    tcfg = t_reduced(t_get_config(arch), dtype="float32")
    api = build(tcfg, "cpu")
    params = api.init_params(torch.Generator().manual_seed(0))
    with pytest.raises(NotImplementedError):
        TSQ.apply_smoothquant(params, {"layers": {}}, tcfg)
    jcfg = reduced(get_config(arch), dtype="float32")
    with pytest.raises(NotImplementedError):
        JSQ.apply_smoothquant({}, {"layers": {}}, jcfg)
