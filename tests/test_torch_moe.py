"""The port's MoE layer (``repro_torch.models.moe``) against the JAX
package's (``repro.models.moe``): the single-device invariants of the JAX
package's own tests, then routing, ranks, capacity and the sublayer on the
same numpy-built inputs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.moe as JM
from repro.models.config import ModelConfig as JConfig
from repro.models.layers import Ctx as JCtx
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Ctx
from repro_torch.models.moe import (
    MoE, _capacity, _local_combine, _local_dispatch, _positions_in_expert, _route,
    dispatch_from_strategy, moe_sublayer,
)
from repro_torch.core.strategies import Comm, MigratoryStrategy


def _kw(e=4, k=2, cap=2.0, d=64):
    return dict(name="t", family="moe", num_layers=1, d_model=d, num_heads=2, num_kv_heads=2,
                d_ff=128, vocab_size=64, num_experts=e, experts_per_token=k, moe_d_ff=32,
                capacity_factor=cap, dtype="float32", remat=False)


def _cfg(**kw):
    return ModelConfig(**_kw(**kw))


def _jcfg(**kw):
    return JConfig(**_kw(**kw))


def _np(x) -> np.ndarray:
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _normal(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# -- the JAX package's single-device tests (tests/test_moe.py), on the port --------


def test_positions_in_expert():
    ef = torch.tensor([2, 0, 2, 1, 2, 0], dtype=torch.int32)
    np.testing.assert_array_equal(_np(_positions_in_expert(ef, 3)), [0, 0, 1, 0, 2, 1])


def test_route_gates_normalized():
    cfg = _cfg()
    gates, experts = _route(cfg, torch.from_numpy(_normal((16, 64), 0)),
                            torch.from_numpy(_normal((64, 4), 1)))
    np.testing.assert_allclose(_np(gates.sum(-1)), 1.0, rtol=1e-5)
    assert int(experts.max()) < 4
    assert all(len(set(r.tolist())) == 2 for r in experts)  # top-k distinct experts


def test_dispatch_combine_roundtrip_identity_experts():
    """With identity expert FFNs, dispatch + combine reproduce the input for
    tokens under capacity."""
    cfg = _cfg(cap=8.0)  # ample capacity: nothing dropped
    t, d = 12, 64
    xt = torch.from_numpy(_normal((t, d), 0))
    gates = torch.full((t, 2), 0.5)
    experts = torch.stack([torch.arange(t) % 4, (torch.arange(t) + 1) % 4], dim=1)
    cap = _capacity(cfg, t, 4)
    buf, ef, pos, keep = _local_dispatch(cfg, xt, gates, experts, cap)
    assert bool(keep.all())
    out = _local_combine(cfg, buf, gates, ef, pos, keep, t, d)  # identity "FFN"
    np.testing.assert_allclose(_np(out), _np(xt), rtol=1e-5)


def test_capacity_drops_overflow():
    cfg = _cfg(cap=0.25)
    t = 32
    xt = torch.from_numpy(_normal((t, 64), 0))
    experts = torch.zeros((t, 2), dtype=torch.long)  # everyone wants expert 0
    cap = _capacity(cfg, t, 4)
    _, _, _, keep = _local_dispatch(cfg, xt, torch.full((t, 2), 0.5), experts, cap)
    assert int(keep.sum()) == cap  # exactly capacity kept, rest dropped


def test_single_device_moe_forward():
    cfg = _cfg()
    p = MoE(cfg, torch.Generator().manual_seed(0), "cpu")
    x = torch.from_numpy(_normal((2, 8, 64), 1))
    out = moe_sublayer(Ctx(cfg), p, x)
    assert out.shape == x.shape and not bool(torch.isnan(out).any())


# -- parity with the JAX package ---------------------------------------------------


def _route_gap(logits: np.ndarray, k: int) -> float:
    """The least gap between the k-th and (k+1)-th routing probability."""
    z = np.exp(logits - logits.max(-1, keepdims=True))
    probs = np.sort(z / z.sum(-1, keepdims=True), axis=-1)[:, ::-1]
    return float((probs[:, k - 1] - probs[:, k]).min())


@pytest.mark.parametrize("e,k,t,seed", [(4, 2, 16, 0), (8, 2, 64, 1), (64, 6, 48, 2)])
def test_route_matches(e, k, t, seed):
    # the router at its init scale, N(0, 0.02), as both packages draw it
    x, router = _normal((t, 64), seed), 0.02 * _normal((64, e), seed + 10)
    # a near tie at the k-th place could route differently in either package
    # by float32 rounding alone (1e-8 on these probabilities); these seeds
    # sit at least 1e-5 from one
    assert _route_gap(x.astype(np.float64) @ router, k) > 1e-5
    jg, je = JM._route(_jcfg(e=e, k=k), jnp.asarray(x), jnp.asarray(router))
    tg, te = _route(_cfg(e=e, k=k), torch.from_numpy(x), torch.from_numpy(router))
    np.testing.assert_array_equal(_np(te), np.asarray(je))
    np.testing.assert_allclose(_np(tg), np.asarray(jg), rtol=1e-6)


def test_route_ties_keep_the_lowest_index_first():
    """Equal probabilities (a zero router) rank as jax.lax.top_k ranks them."""
    x, router = _normal((5, 64), 3), np.zeros((64, 8), np.float32)
    _, je = JM._route(_jcfg(e=8, k=3), jnp.asarray(x), jnp.asarray(router))
    _, te = _route(_cfg(e=8, k=3), torch.from_numpy(x), torch.from_numpy(router))
    np.testing.assert_array_equal(_np(te), np.asarray(je))
    np.testing.assert_array_equal(_np(te), np.tile([0, 1, 2], (5, 1)))


@pytest.mark.parametrize("case", ["random", "all_expert_0"])
@pytest.mark.parametrize("cap_factor", [2.0, 0.25])
def test_positions_keep_and_capacity_match(case, cap_factor):
    t, e, k = 40, 4, 2
    if case == "random":
        experts = np.random.default_rng(4).integers(0, e, (t, k)).astype(np.int32)
    else:
        experts = np.zeros((t, k), np.int32)
    jcfg, cfg = _jcfg(e=e, k=k, cap=cap_factor), _cfg(e=e, k=k, cap=cap_factor)
    cap = _capacity(cfg, t, e)
    assert cap == JM._capacity(jcfg, t, e)
    ef = experts.reshape(-1)
    np.testing.assert_array_equal(_np(_positions_in_expert(torch.from_numpy(ef), e)),
                                  np.asarray(JM._positions_in_expert(jnp.asarray(ef), e)))
    x, gates = _normal((t, 64), 5), np.full((t, k), 0.5, np.float32)
    jbuf, _, jpos, jkeep = JM._local_dispatch(jcfg, jnp.asarray(x), jnp.asarray(gates),
                                              jnp.asarray(experts), cap)
    tbuf, _, tpos, tkeep = _local_dispatch(cfg, torch.from_numpy(x), torch.from_numpy(gates),
                                           torch.from_numpy(experts), cap)
    np.testing.assert_array_equal(_np(tpos), np.asarray(jpos))
    np.testing.assert_array_equal(_np(tkeep), np.asarray(jkeep))
    np.testing.assert_array_equal(_np(tbuf), np.asarray(jbuf))  # the binning moves, never sums


@pytest.mark.parametrize("cap_factor", [8.0, 0.25])
def test_moe_sublayer_matches(cap_factor):
    """Ample capacity, and the drop-heavy factor 0.25 where most slots are
    dropped: the same tokens must be dropped in both packages."""
    jcfg, cfg = _jcfg(e=8, k=2, cap=cap_factor), _cfg(e=8, k=2, cap=cap_factor)
    jp = jax.tree.map(lambda a: np.asarray(a, np.float32), JM.moe_params(jcfg, jax.random.PRNGKey(0)))
    p = MoE(cfg, torch.Generator().manual_seed(0), "cpu")
    p.load_state_dict({name: torch.from_numpy(np.array(a)) for name, a in jp.items()})
    x = _normal((2, 24, 64), 6)
    assert _route_gap(x.reshape(-1, 64).astype(np.float64) @ jp["router"], 2) > 1e-5
    want = JM.moe_sublayer(JCtx(jcfg), jax.tree.map(jnp.asarray, jp), jnp.asarray(x))
    with torch.no_grad():
        got = moe_sublayer(Ctx(cfg), p, torch.from_numpy(x))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5, atol=1e-5)
    # one device: an explicit mode or strategy gives the single-shard result
    with torch.no_grad():
        for kw in ({"dispatch": "ep_pull"}, {"strategy": MigratoryStrategy(comm=Comm.MIGRATE)}):
            assert torch.equal(moe_sublayer(Ctx(cfg), p, torch.from_numpy(x), **kw), got)


def test_moe_params_layout_matches():
    jcfg, cfg = _jcfg(e=8), _cfg(e=8)
    jp = JM.moe_params(jcfg, jax.random.PRNGKey(0))
    p = MoE(cfg, torch.Generator().manual_seed(0), "cpu")
    for name, a in jp.items():
        t = getattr(p, name)
        assert tuple(t.shape) == a.shape and str(t.dtype).removeprefix("torch.") == str(a.dtype)


@pytest.mark.parametrize("comm", list(Comm))
@pytest.mark.parametrize("e,axis", [(8, 1), (8, 4), (6, 4), (64, 8)])
def test_dispatch_from_strategy_matches(comm, e, axis):
    st = MigratoryStrategy(comm=comm)
    import repro.core.strategies as JS

    jst = JS.MigratoryStrategy(comm=JS.Comm(comm.value))
    assert dispatch_from_strategy(st, num_experts=e, data_axis=axis) == \
        JM.dispatch_from_strategy(jst, num_experts=e, data_axis=axis)
    assert dispatch_from_strategy(None, num_experts=e, data_axis=axis) is None
