"""The port's MoE decode serving against the JAX package's, on ``serve-moe``
in float32 with the JAX package's ``moe_decode_params`` carried over by
``convert.moe_decode_params_from_numpy``: the non-mesh tests of the JAX
package's ``tests/test_decode_serving.py`` on the port (expert FFNs behind
``moe_dispatch``, ``moe_decode`` through the engine, ``DecodeServer``'s
continuous batching, every route token-for-token equal to the port's
oracle), then ``moe_decode`` against ``moe_decode_reference`` (within
``1e-5``, every mode) and ``DecodeServer`` against the reference's server:
per-step logits under teacher forcing, free-running tokens as far as the
reference's top-two margin is clear of ties."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JCfg
import repro.core as JC
import repro.engine as J
import repro.models.moe as JM
import repro.models.transformer as JT
from repro_torch.configs import get_config
from repro_torch.convert import moe_decode_params_from_numpy
from repro_torch.core import Comm, MigratoryStrategy
from repro_torch.engine import (
    CudaSubstrate, DecodeServer, EngineService, LocalSubstrate, MoEDecodeInputs,
    MoEDispatchInputs, OpNotSupportedError, PlanCache, Request, moe_decode_reference,
    moe_decode_traffic, run,
)
from repro_torch.models.config import ModelConfig
from repro_torch.models.moe import MoE, expert_ffn
from repro_torch.models.transformer import moe_decode_params

CPU = "cpu"
TOL = dict(rtol=1e-5, atol=1e-5)
EP_PULL = MigratoryStrategy(comm=Comm.MIGRATE)
EP_PUSH = MigratoryStrategy(comm=Comm.REMOTE_WRITE)
# (label, strategy, nodelets): serve-moe has 8 experts, so nodelets=4 gives
# the two expert-parallel modes and nodelets=1 the tp replication fallback
MODES = (("ep_pull", EP_PULL, 4), ("ep_push", EP_PUSH, 4), ("tp", None, 1))
# near-tied greedy picks are not compared (random weights give some)
MARGIN = 1e-4


def _ref_strategy(st):
    return None if st is None else JC.MigratoryStrategy(comm=JC.Comm(st.comm.value))


@pytest.fixture(scope="module")
def cfg():
    return get_config("serve-moe")


@pytest.fixture(scope="module")
def ref_params():
    return JT.moe_decode_params(JCfg.get_config("serve-moe"), jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def params(cfg, ref_params):
    """The reference's params, carried over."""
    tree = {k: np.asarray(v, np.float32) for k, v in ref_params.items()}
    return moe_decode_params_from_numpy(cfg, tree, device=CPU)


# -- expert FFNs ride the dispatch transport ------------------------------------------


def test_dispatch_applies_expert_ffn_identically_across_modes():
    """With expert weights attached, all three transports compute the same
    expert outputs at no-drop capacity."""
    mcfg = ModelConfig(
        name="t", family="moe", num_layers=1, d_model=16, num_heads=1, num_kv_heads=1,
        d_ff=32, vocab_size=64, num_experts=8, experts_per_token=2, moe_d_ff=24,
        dtype="float32", remat=False,
    )
    mp = MoE(mcfg, torch.Generator().manual_seed(1), CPU)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((32, 16)).astype(np.float32))
    common = dict(x=x, router=mp.router.detach(), w_gate=mp.w_gate.detach(),
                  w_up=mp.w_up.detach(), w_down=mp.w_down.detach(), experts_per_token=2,
                  capacity_factor=8.0)
    outs = {}
    for label, st, nod in MODES:
        y, rep = run(Request("moe_dispatch", MoEDispatchInputs(nodelets=nod, **common), st,
                             LocalSubstrate(CPU)), iters=1, warmup=0, cache=PlanCache())
        assert rep.metrics["expert_ffn"] is True
        outs[label] = y
        assert not torch.allclose(y, torch.zeros_like(y))  # the FFN ran
    assert torch.equal(outs["ep_pull"], outs["tp"])
    assert torch.equal(outs["ep_push"], outs["tp"])


def test_expert_ffn_wrapper_keeps_zero_rows_zero():
    mcfg = ModelConfig(
        name="t2", family="moe", num_layers=1, d_model=8, num_heads=1, num_kv_heads=1,
        d_ff=16, vocab_size=32, num_experts=4, experts_per_token=2, moe_d_ff=12,
        dtype="float32", remat=False,
    )
    mp = MoE(mcfg, torch.Generator().manual_seed(3), CPU)
    ffn = {k: getattr(mp, k).detach() for k in ("w_gate", "w_up", "w_down")}
    assert not expert_ffn(ffn, torch.zeros((4, 3, 8))).any()
    # the reference's wrapper agrees on the same weights and inputs
    xs = np.random.default_rng(4).standard_normal((4, 3, 8)).astype(np.float32)
    want = JM.expert_ffn({k: jnp.asarray(v.numpy()) for k, v in ffn.items()}, jnp.asarray(xs))
    np.testing.assert_allclose(expert_ffn(ffn, torch.from_numpy(xs)).numpy(), np.asarray(want),
                               **TOL)


def test_dispatch_rejects_partial_expert_weights():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((16, 8)).astype(np.float32))
    router = torch.from_numpy(rng.standard_normal((8, 4)).astype(np.float32))
    inputs = MoEDispatchInputs(x=x, router=router, w_gate=torch.zeros((4, 8, 12)))
    with pytest.raises(ValueError, match="all-or-none"):
        run(Request("moe_dispatch", inputs, None, LocalSubstrate(CPU)), iters=1, warmup=0,
            cache=PlanCache())


def test_moe_decode_params_layout_matches(cfg, ref_params):
    """The port's own draw has the reference's keys, shapes and types, the
    norms at ones."""
    got = moe_decode_params(cfg, seed=0, device=CPU)
    assert sorted(got) == sorted(ref_params)
    for name, a in ref_params.items():
        assert tuple(got[name].shape) == a.shape, name
        assert str(got[name].dtype).removeprefix("torch.") == str(a.dtype), name
    for name in ("ln1", "ln2", "ln_f"):
        assert torch.equal(got[name], torch.ones_like(got[name]))


# -- moe_decode through the engine -------------------------------------------------


def _arrays(cfg, batch=8, seq=16, seed=0, random_caches=False) -> dict:
    rng = np.random.default_rng(seed)
    d = cfg.d_model
    if random_caches:  # a mid-session batch: filled caches, scattered cursors
        k = rng.standard_normal((batch, seq, d)).astype(np.float32)
        v = rng.standard_normal((batch, seq, d)).astype(np.float32)
        pos = rng.integers(0, seq - 1, batch).astype(np.int32)
    else:
        k = v = np.zeros((batch, seq, d), np.float32)
        pos = np.zeros((batch,), np.int32)
    return {"tokens": rng.integers(1, cfg.vocab_size, batch).astype(np.int32),
            "k_cache": k, "v_cache": v, "positions": pos}


def _decode_inputs(cfg, params, batch=8, seq=16, seed=0, nodelets=4, random_caches=False):
    a = _arrays(cfg, batch, seq, seed, random_caches)
    return MoEDecodeInputs(
        params=params, nodelets=nodelets, experts_per_token=cfg.experts_per_token,
        capacity_factor=cfg.capacity_factor, **{k: torch.from_numpy(v) for k, v in a.items()},
    )


@pytest.mark.parametrize("label,strategy,nodelets", MODES)
def test_moe_decode_engine_matches_oracle(cfg, params, label, strategy, nodelets):
    """One decode step served through the engine is bit-identical to the
    port's single-process oracle."""
    inputs = _decode_inputs(cfg, params, nodelets=nodelets)
    out, rep = run(Request("moe_decode", inputs, strategy, LocalSubstrate(CPU)),
                   iters=1, warmup=0, cache=PlanCache())
    ref = moe_decode_reference(inputs, strategy)
    assert rep.metrics["dispatch_mode"] == label
    for got, want in zip(out, ref):
        assert torch.equal(got, want)
    traffic = moe_decode_traffic(inputs, strategy)
    if label == "tp":
        assert traffic.total_bytes == 0
    else:
        assert traffic.collective_bytes > 0
    assert not inputs.k_cache.any()  # the step's caches are new tensors


def test_moe_decode_rejects_bad_batch_or_params_and_cuda(cfg, params):
    inputs = _decode_inputs(cfg, params, batch=6, nodelets=4)  # 6 % 4 != 0
    with pytest.raises(ValueError, match="nodelets"):
        run(Request("moe_decode", inputs, None, LocalSubstrate(CPU)), iters=1, warmup=0,
            cache=PlanCache())
    short = {k: v for k, v in params.items() if k != "lm_head"}
    with pytest.raises(ValueError, match="lm_head"):
        run(Request("moe_decode", _decode_inputs(cfg, short), None, LocalSubstrate(CPU)),
            iters=1, warmup=0, cache=PlanCache())
    with pytest.raises(OpNotSupportedError, match="moe_decode"):
        run(Request("moe_decode", _decode_inputs(cfg, params), None, CudaSubstrate(CPU)),
            iters=1, warmup=0, cache=PlanCache())


@pytest.mark.parametrize("random_caches", [False, True], ids=["fresh", "mid_session"])
@pytest.mark.parametrize("label,strategy,nodelets", MODES + (("ep_push_8", EP_PUSH, 8),))
def test_moe_decode_matches_reference(cfg, params, ref_params, label, strategy, nodelets,
                                      random_caches):
    a = _arrays(cfg, seed=1, random_caches=random_caches)
    port_in = MoEDecodeInputs(params=params, nodelets=nodelets,
                              experts_per_token=cfg.experts_per_token,
                              capacity_factor=cfg.capacity_factor,
                              **{k: torch.from_numpy(v) for k, v in a.items()})
    ref_in = J.MoEDecodeInputs(params=ref_params, nodelets=nodelets,
                               experts_per_token=cfg.experts_per_token,
                               capacity_factor=cfg.capacity_factor,
                               **{k: jnp.asarray(v) for k, v in a.items()})
    got = moe_decode_reference(port_in, strategy)
    want = J.moe_decode_reference(ref_in, _ref_strategy(strategy))
    for name, g, w in zip(("logits", "k_cache", "v_cache"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL, err_msg=name)
    assert (moe_decode_traffic(port_in, strategy).total_bytes
            == J.moe_decode_traffic(ref_in, _ref_strategy(strategy) or JC.MigratoryStrategy())
            .total_bytes)


# -- DecodeServer continuous batching ------------------------------------------------


def _prompts(cfg):
    rng = np.random.default_rng(7)
    return [
        (rng.integers(1, cfg.vocab_size, size=int(n)).tolist(), int(m))
        for n, m in zip(rng.integers(2, 6, size=6), (3, 5, 2, 4, 3, 2))
    ]


SCHEDULE = (0, 1, 0, 2, 0, 1)  # joins interleaved with decode steps


def _drive(server, prompts, schedule=SCHEDULE):
    """Feed prompts per the schedule — sequences join while others are
    mid-decode, finish at different steps, and free slots refill from the
    waiting queue (continuous batching)."""
    for (prompt, max_new), step_now in zip(prompts, schedule):
        server.add(prompt, max_new_tokens=max_new)
        for _ in range(step_now):
            server.step()
    server.run_until_drained()
    return dict(server.results)


@pytest.mark.parametrize("label,strategy,nodelets", MODES)
def test_served_decode_bit_identical_to_oracle(cfg, params, label, strategy, nodelets):
    """Continuous-batched decode through engine.run and EngineService (batch
    and worker modes) emits exactly the port oracle's tokens under a
    join/leave schedule, for every dispatch mode."""
    prompts = _prompts(cfg)
    mk = dict(capacity=4, max_len=16, nodelets=nodelets, strategy=strategy, device=CPU)
    oracle = _drive(DecodeServer(cfg, params, oracle=True, **mk), prompts)
    assert sorted(oracle) == list(range(len(prompts)))  # ids are add-order
    assert all(len(oracle[i]) == m for i, (_, m) in enumerate(prompts))

    assert _drive(DecodeServer(cfg, params, **mk), prompts) == oracle

    batch_svc = EngineService(cache=PlanCache(), device=CPU)
    assert _drive(DecodeServer(cfg, params, service=batch_svc, **mk), prompts) == oracle

    worker_svc = EngineService(cache=PlanCache(), device=CPU, workers=2, slo_target_seconds=600.0)
    worker_svc.start()
    try:
        worked = _drive(DecodeServer(cfg, params, service=worker_svc, **mk), prompts)
    finally:
        worker_svc.stop()
    assert worked == oracle
    stats = worker_svc.stats()
    assert stats.slo_checked > 0 and stats.slo_violations == 0
    assert stats.total_p99 > 0.0


def test_decode_server_admission_and_retirement(cfg, params):
    server = DecodeServer(cfg, params, capacity=2, max_len=16, nodelets=1, oracle=True,
                          device=CPU)
    ids = [server.add([5, 6], max_new_tokens=2) for _ in range(4)]
    assert len(server._waiting) == 2  # capacity 2: last two queue
    server.run_until_drained()
    assert sorted(server.results) == sorted(ids)
    assert all(len(toks) == 2 for toks in server.results.values())
    with pytest.raises(ValueError):
        server.add([], max_new_tokens=1)
    with pytest.raises(ValueError):
        server.add([1] * 20, max_new_tokens=1)  # prompt + new > max_len
    with pytest.raises(ValueError, match="oracle"):
        DecodeServer(cfg, params, oracle=True, strategy="auto", device=CPU)


def test_served_step_failure_reaches_the_caller(cfg, params):
    """A step that fails in the worker loop raises from ``step``: the
    future carries the exception."""
    bad = dict(params, lm_head=params["lm_head"][:, :7].T.contiguous())  # a wrong shape
    svc = EngineService(cache=PlanCache(), device=CPU).start()
    try:
        server = DecodeServer(cfg, bad, capacity=4, max_len=16, service=svc, device=CPU)
        server.add([3, 4], max_new_tokens=2)
        with pytest.raises(RuntimeError):
            server.step()
    finally:
        svc.stop()


def _record(server):
    """Wrap ``server._execute`` to keep each step's (slot of every active
    sequence, logits)."""
    steps, execute = [], server._execute

    def recording(inputs):
        out = execute(inputs)
        slots = {s.id: s.slot for s in server._slots if s is not None}
        steps.append((slots, np.asarray(out[0], np.float32)))
        return out

    server._execute = recording
    return steps


@pytest.mark.parametrize("label,strategy,nodelets", MODES)
def test_decode_server_matches_reference(cfg, params, ref_params, label, strategy, nodelets):
    """Teacher forcing: each step of the reference's server (its tokens and
    cursors) replayed through the port's ``moe_decode``, caches threaded,
    logits within 1e-5. Free running: the port's served tokens equal the
    reference's as far as the reference's top-two margin exceeds 1e-4."""
    prompts = _prompts(cfg)
    jcfg = JCfg.get_config("serve-moe")
    ref_server = J.DecodeServer(jcfg, ref_params, capacity=4, max_len=16, nodelets=nodelets,
                                strategy=_ref_strategy(strategy), oracle=True)
    inputs_seen = []
    ref_execute = ref_server._execute

    def keep_inputs(inputs):
        inputs_seen.append((np.array(inputs.tokens), np.array(inputs.positions)))  # copies
        return ref_execute(inputs)

    ref_server._execute = keep_inputs
    ref_steps = _record(ref_server)
    want = _drive(ref_server, prompts)

    k = v = torch.zeros((4, 16, cfg.d_model))
    for i, ((tokens, positions), (_, ref_logits)) in enumerate(zip(inputs_seen, ref_steps)):
        inputs = MoEDecodeInputs(params=params, tokens=torch.from_numpy(tokens),
                                 k_cache=k, v_cache=v,
                                 positions=torch.from_numpy(positions), nodelets=nodelets,
                                 experts_per_token=cfg.experts_per_token,
                                 capacity_factor=cfg.capacity_factor)
        (logits, k, v), _ = run(Request("moe_decode", inputs, strategy, LocalSubstrate(CPU)),
                                iters=1, warmup=0, cache=PlanCache())
        np.testing.assert_allclose(logits.numpy(), ref_logits, **TOL, err_msg=f"step {i}")

    # free running: compare each sequence's tokens up to its first near tie
    got = _drive(DecodeServer(cfg, params, capacity=4, max_len=16, nodelets=nodelets,
                              strategy=strategy, oracle=True, device=CPU), prompts)
    clear = {}
    for sid, ms in _margins(ref_steps, want, prompts).items():
        assert len(ms) == len(want[sid])
        tied = [i for i, m in enumerate(ms) if m <= MARGIN]
        clear[sid] = tied[0] if tied else len(ms)
    compared = sum(clear.values())
    assert compared >= sum(len(t) for t in want.values()) // 2  # most tokens are compared
    for sid, n in clear.items():
        assert got[sid][:n] == want[sid][:n], sid


def _margins(ref_steps, want, prompts) -> dict:
    """Each sequence's top-two logit margin at each of its greedy picks, in
    order, from the recorded steps of the reference's server."""
    out = {sid: [] for sid in want}
    fed = {sid: 0 for sid in want}  # decode steps each sequence took so far
    for slots, logits in ref_steps:
        for sid, slot in slots.items():
            fed[sid] += 1
            if fed[sid] >= len(prompts[sid][0]) and len(out[sid]) < len(want[sid]):
                top2 = np.sort(logits[slot])[-2:]
                out[sid].append(float(top2[1] - top2[0]))
    return out


def test_entry_points_raise_without_a_card(cfg, params, monkeypatch):
    """Left on their default device, the card, the MoE entry points raise
    on a machine without one instead of running on the CPU."""
    from repro_torch.launch.serve import decode_serve_demo
    from repro_torch.models import api

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: DecodeServer(cfg, params), lambda: moe_decode_params(cfg),
                 lambda: decode_serve_demo(n_seqs=1),
                 lambda: api.init_params(get_config("moonshot-v1-16b-a3b")),
                 lambda: moe_decode_params_from_numpy(cfg, {k: v.numpy() for k, v in params.items()}),
                 lambda: run(Request("moe_decode", _decode_inputs(cfg, params)))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
