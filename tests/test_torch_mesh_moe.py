"""``moe_dispatch`` and ``moe_decode`` on the port's ``mesh`` substrate:
gloo rank processes on the CPU, one module mesh of 4 ranks and one of 8.

The mesh is held bit-identical to the port's ``local`` route (ep_push,
ep_pull and tp at 4 and 8 ranks, with and without expert weights), and to
the JAX package's ``local`` route within ``1e-5``; dispatch mode, dropped
slots and traffic equal. An explicit mesh of the wrong width raises, as
the reference's does (``tests/test_moe_op.py``). ``moe_decode`` on
``serve-moe`` (the reference's params carried over) equals the port's
``local`` step and the reference's at 4 and 8 ranks (tp at 1), and
``DecodeServer`` through ``EngineService(substrate="mesh")`` emits the
oracle's tokens. (The reference's own local-vs-mesh decode test fails:
ROADMAP §3, so the reference's ``local`` route is the yardstick.)

Every test has a time limit of its own (an alarm), every mesh call one."""
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JCfg
import repro.core as JC
import repro.engine as J
import repro.models.transformer as JT
from repro_torch.configs import get_config
from repro_torch.convert import moe_decode_params_from_numpy
from repro_torch.core import Comm, MigratoryStrategy
from repro_torch.engine import (
    DecodeServer, EngineService, LocalSubstrate, MeshSubstrate, MoEDecodeInputs,
    MoEDispatchInputs, OpNotSupportedError, PlanCache, Request, moe_decode_reference,
    moe_dispatch_reference, run,
)
from repro_torch.launch.mesh import close_meshes, make_nodelet_mesh

CPU = "cpu"
MESH_TIMEOUT_S = 30.0
TEST_LIMIT_S = 90
TOL = dict(rtol=1e-5, atol=1e-5)
EP_PULL = MigratoryStrategy(comm=Comm.MIGRATE)
EP_PUSH = MigratoryStrategy(comm=Comm.REMOTE_WRITE)
# (label, strategy, experts): 8 experts divide over 4 and 8 ranks (the ep
# modes); 6 over 4 and 12 over 8 do not, so every strategy takes tp
DISPATCH_CASES = {4: (("ep_push", EP_PUSH, 8), ("ep_pull", EP_PULL, 8), ("tp", EP_PUSH, 6)),
                  8: (("ep_push", EP_PUSH, 8), ("ep_pull", EP_PULL, 8), ("tp", EP_PULL, 12))}


@pytest.fixture(autouse=True)
def _time_limit():
    def expire(signum, frame):
        raise TimeoutError(f"test exceeded its {TEST_LIMIT_S} s limit")

    previous = signal.signal(signal.SIGALRM, expire)
    signal.alarm(TEST_LIMIT_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, previous)


@pytest.fixture(autouse=True)
def _no_machine_files(tmp_path, monkeypatch):
    from repro_torch.engine import probes
    from repro_torch.machine import reset_default_machine_cache

    monkeypatch.setenv("REPRO_TORCH_MACHINE_PATH", str(tmp_path / "absent_machine.json"))
    monkeypatch.setenv("REPRO_TORCH_PROBES_PATH", str(tmp_path / "absent_probes.json"))
    monkeypatch.setattr(probes, "_default_store", None)
    reset_default_machine_cache()
    yield
    reset_default_machine_cache()


@pytest.fixture(scope="module", autouse=True)
def meshes():
    """The module's meshes, started once (4 and 8 ranks) and closed after."""
    yield {p: make_nodelet_mesh(p, CPU, timeout=MESH_TIMEOUT_S) for p in (4, 8)}
    close_meshes()


def _arrays(T, D, E, seed=7, experts=False) -> dict:
    rng = np.random.default_rng(seed)
    out = {"x": rng.standard_normal((T, D)).astype(np.float32),
           "router": rng.standard_normal((D, E)).astype(np.float32)}
    if experts:
        F = 12
        for name, shape in (("w_gate", (E, D, F)), ("w_up", (E, D, F)), ("w_down", (E, F, D))):
            out[name] = (0.2 * rng.standard_normal(shape)).astype(np.float32)
    return out


def _ref_strategy(st):
    return None if st is None else JC.MigratoryStrategy(comm=JC.Comm(st.comm.value))


def _run(op, inputs, st, sub):
    return run(Request(op, inputs, st, sub), iters=1, warmup=0, cache=PlanCache())


# -- moe_dispatch ------------------------------------------------------------------


@pytest.mark.parametrize("experts", [False, True], ids=["identity", "swiglu"])
@pytest.mark.parametrize("p,case", [(p, c) for p in (4, 8) for c in range(3)])
def test_dispatch_mesh_bit_identical_to_local_and_close_to_reference(p, case, experts):
    label, st, n_experts = DISPATCH_CASES[p][case]
    a = _arrays(64, 16, n_experts, experts=experts)
    inputs = MoEDispatchInputs(nodelets=p, **{k: torch.from_numpy(v) for k, v in a.items()})
    got, rep = _run("moe_dispatch", inputs, st, MeshSubstrate(CPU))
    want, rep_local = _run("moe_dispatch", inputs, st, LocalSubstrate(CPU))
    assert rep.metrics["dispatch_mode"] == label and rep.metrics == rep_local.metrics
    assert torch.equal(got, want) and torch.equal(got, moe_dispatch_reference(inputs, st))
    assert rep.traffic == rep_local.traffic and rep.bytes_moved == rep_local.bytes_moved
    ref_in = J.MoEDispatchInputs(nodelets=p, **{k: jnp.asarray(v) for k, v in a.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(J.moe_dispatch_reference(
        ref_in, _ref_strategy(st))), **TOL)


def test_explicit_mesh_of_the_wrong_width_raises(meshes):
    inputs = MoEDispatchInputs(nodelets=8, **{k: torch.from_numpy(v)
                                              for k, v in _arrays(64, 16, 8).items()})
    with pytest.raises(OpNotSupportedError, match="8-rank nodelet mesh"):
        _run("moe_dispatch", inputs, EP_PUSH, MeshSubstrate(CPU, meshes[4]))
    # the right width runs
    got, _ = _run("moe_dispatch", inputs, EP_PUSH, MeshSubstrate(CPU, meshes[8]))
    assert torch.equal(got, moe_dispatch_reference(inputs, EP_PUSH))


# -- moe_decode --------------------------------------------------------------------


@pytest.fixture(scope="module")
def cfg():
    return get_config("serve-moe")


@pytest.fixture(scope="module")
def ref_params():
    return JT.moe_decode_params(JCfg.get_config("serve-moe"), jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def params(cfg, ref_params):
    tree = {k: np.asarray(v, np.float32) for k, v in ref_params.items()}
    return moe_decode_params_from_numpy(cfg, tree, device=CPU)


def _decode_arrays(cfg, batch=8, seq=16, seed=1) -> dict:
    """A mid-session batch: filled caches, scattered cursors."""
    rng = np.random.default_rng(seed)
    d = cfg.d_model
    return {"tokens": rng.integers(1, cfg.vocab_size, batch).astype(np.int32),
            "k_cache": rng.standard_normal((batch, seq, d)).astype(np.float32),
            "v_cache": rng.standard_normal((batch, seq, d)).astype(np.float32),
            "positions": rng.integers(0, seq - 1, batch).astype(np.int32)}


@pytest.mark.parametrize("label,strategy,nodelets", [
    ("ep_push", EP_PUSH, 4), ("ep_pull", EP_PULL, 4), ("ep_push", EP_PUSH, 8),
    ("ep_pull", EP_PULL, 8), ("tp", None, 1),
])
def test_moe_decode_mesh_equals_local_and_reference(cfg, params, ref_params, label, strategy,
                                                   nodelets):
    a = _decode_arrays(cfg)
    common = dict(nodelets=nodelets, experts_per_token=cfg.experts_per_token,
                  capacity_factor=cfg.capacity_factor)
    inputs = MoEDecodeInputs(params=params, **common, **{k: torch.from_numpy(v)
                                                          for k, v in a.items()})
    got, rep = _run("moe_decode", inputs, strategy, MeshSubstrate(CPU))
    local, _ = _run("moe_decode", inputs, strategy, LocalSubstrate(CPU))
    assert rep.metrics["dispatch_mode"] == label and rep.substrate == "mesh"
    for g, lo, o in zip(got, local, moe_decode_reference(inputs, strategy)):
        assert torch.equal(g, lo) and torch.equal(g, o)
    ref_in = J.MoEDecodeInputs(params=ref_params, **common,
                               **{k: jnp.asarray(v) for k, v in a.items()})
    want = J.moe_decode_reference(ref_in, _ref_strategy(strategy))
    for name, g, w in zip(("logits", "k_cache", "v_cache"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL, err_msg=name)


def test_decode_server_through_the_mesh_service_emits_the_oracle_tokens(cfg, params):
    """``DecodeServer`` on ``EngineService(substrate="mesh")``, ep_push at 4
    ranks, sequences joining mid-decode: every token the oracle's."""
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, cfg.vocab_size, size=int(n)).tolist() for n in (2, 5, 3, 4, 2)]
    mk = dict(capacity=4, max_len=16, nodelets=4, strategy=EP_PUSH, device=CPU)

    def drive(server):
        for i, prompt in enumerate(prompts):
            server.add(prompt, max_new_tokens=3)
            if i % 2:
                server.step()
        return dict(server.run_until_drained())

    oracle = drive(DecodeServer(cfg, params, oracle=True, **mk))
    svc = EngineService(substrate="mesh", device=CPU, workers=2, cache=PlanCache()).start()
    try:
        served = drive(DecodeServer(cfg, params, service=svc, substrate="mesh", **mk))
    finally:
        svc.stop()
    assert served == oracle and sorted(served) == list(range(len(prompts)))
    assert svc.stats().steals == 0
