"""The port's learned straggler predictor (``repro_torch.predict``)
against the reference package's.

1. **Features** — ``extract_features``/``candidate_rows`` give the
   reference's arrays on a hand-built snapshot and on one mid-run
   snapshot of the same seeded run.
2. **Corpus** — ``generate_corpus`` writes the reference's bytes: at two
   seeds on a reduced run list and once on the full default corpus, on
   ``"numpy"`` and on ``TorchBackend("cpu")`` (B1–B4's plain versions).
3. **Model** — ``forward_np``/``scores_np`` equal the reference's,
   ``forward_torch`` agrees with them, and checkpoints written by either
   package's ``train`` load in the other.
4. **Training** — from the reference's ``init_params(0)`` (carried over
   by ``from_jax_params``, the port's ``init_params`` monkeypatched), the
   port's ``train`` against the reference's: at 20 steps the loss to 1e-6
   and each trained leaf within 1e-5 of its norm (measured 1.5e-6 at most
   over 1, 2, 4 and 8 threads); at 400 steps the calibrated threshold
   within one step of the calibration grid (0.05) and the final loss
   within 1 % (measured 0.9 or 0.95 against 0.95, and 0.35 %). The
   weights themselves are not bounded at 400 steps: AdamW's sign-like
   steps on near-zero gradients carry float32 rounding into them, and on
   a CPU the thread count alone moved them by 0.019–0.23 of a leaf's
   norm against the reference's.
5. **Policy** — ``Simulation(policy="predictor")`` gives the reference's
   action traces, attempt launches and results byte for byte: with the
   default params, an always-firing net and a reference-trained
   checkpoint, on numpy and ``TorchBackend("cpu")``, across the four
   shuffle engines; obs-on ≡ obs-off; fig_predictor's scenario numbers
   equal; the runtime skips the reference shadow for a learned policy.
6. **Defaults** — the policy, the corpus, ``init_params`` and ``train``
   run on the card by default and raise without one; and
   ``chip_smoke.py``'s predictor phase rehearses on the CPU.
"""
import hashlib
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.predict.dataset as RD
import repro.predict.features as RF
import repro.predict.model as RM
import repro.sim as ref_sim
import repro_torch.predict.dataset as PD
import repro_torch.predict.features as PF
import repro_torch.predict.model as PM
import repro_torch.predict.train as PT
import repro_torch.sim as port_sim
from repro_torch.accel.torch_backend import TorchBackend
from repro_torch.obs import TraceRecorder
from repro_torch.predict.policy import PredictorPolicy

ROOT = Path(__file__).resolve().parents[1]
SMALL_RUNS = (RD.CORPUS_RUNS[0], RD.CORPUS_RUNS[3])
CRASH_AT_20 = [("crash", 1, 0.05, 0.0)]
SHUFFLES = ("rescan", "event", "batch", "kernel")


def _backend(name):
    return TorchBackend("cpu") if name == "torch-cpu" else name


def _sha(path):
    return hashlib.sha256(Path(path).read_bytes()).hexdigest()


def fire_params():
    """Every candidate scores sigmoid(5) ≈ 0.993: the always-speculate
    net of tests/test_predict.py."""
    p = RM.default_params()
    p["b1"] = np.full(1, 5.0)
    return p


# ---------------------------------------------------------------------------
# Shared artifacts: the full default corpus and a reference-trained model
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def ref_corpus(tmp_path_factory):
    path = tmp_path_factory.mktemp("corpus") / "ref.npz"
    RD.generate_corpus(str(path), seed=0)
    return str(path)


@pytest.fixture(scope="module")
def ref_ckpt(ref_corpus, tmp_path_factory):
    from repro.predict.train import train
    out = tmp_path_factory.mktemp("ref_ckpt")
    train(ref_corpus, str(out / "20"), seed=0, steps=20)
    train(ref_corpus, str(out / "400"), seed=0, steps=400)
    return {20: str(out / "20"), 400: str(out / "400")}


# ---------------------------------------------------------------------------
# 1. Features
# ---------------------------------------------------------------------------
def test_extract_features_hand_built_equal_reference():
    from test_predict import FakeArr

    arr = FakeArr()
    got = PF.extract_features(arr, 20.0, np.arange(3))
    np.testing.assert_array_equal(
        got, RF.extract_features(arr, 20.0, np.arange(3)))
    np.testing.assert_array_equal(PF.node_progress_rate(arr, 20.0),
                                  RF.node_progress_rate(arr, 20.0))
    assert PF.FEATURE_NAMES == RF.FEATURE_NAMES
    assert PF.N_FEATURES == RF.N_FEATURES


def _mid_run(pkg, **kw):
    """tests/test_predict.py's mid-run snapshot: yarn, seed 1, a crash
    at 20 s, run to 50 s."""
    sim = pkg.Simulation(policy="yarn", seed=1, **kw)
    job = sim.submit(pkg.JobSpec("j0", "terasort", 2.0))
    pkg.faults.apply_script(sim, job, CRASH_AT_20)
    sim.engine.run(until=50.0)
    return sim._snapshot()


@pytest.mark.parametrize("backend", ["numpy", "torch-cpu"])
def test_features_mid_run_equal_reference(backend):
    port = _mid_run(port_sim, assess_backend=_backend(backend))
    ref = _mid_run(ref_sim)
    now = port.now
    assert now == ref.now
    rows = PF.candidate_rows(port.arrays, now)
    assert len(rows)
    np.testing.assert_array_equal(rows,
                                  RF.candidate_rows(ref.arrays, now))
    got = PF.extract_features(port.arrays, now, rows)
    assert got.shape == (len(rows), PF.N_FEATURES)
    np.testing.assert_array_equal(got,
                                  RF.extract_features(ref.arrays, now, rows))
    np.testing.assert_array_equal(PF.node_progress_rate(port.arrays, now),
                                  RF.node_progress_rate(ref.arrays, now))


# ---------------------------------------------------------------------------
# 2. Corpus bytes
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("backend", ["numpy", "torch-cpu"])
@pytest.mark.parametrize("seed", [0, 1])
def test_corpus_bytes_equal_reference(seed, backend, tmp_path):
    port, ref = tmp_path / "port.npz", tmp_path / "ref.npz"
    meta = PD.generate_corpus(str(port), seed=seed, runs=SMALL_RUNS,
                              assess_backend=_backend(backend))
    assert meta == RD.generate_corpus(str(ref), seed=seed, runs=SMALL_RUNS)
    assert meta["n_positive"] > 0
    assert _sha(port) == _sha(ref)


@pytest.mark.parametrize("backend", ["numpy", "torch-cpu"])
def test_full_corpus_bytes_equal_reference(backend, ref_corpus, tmp_path):
    port = tmp_path / "port.npz"
    meta = PD.generate_corpus(str(port), seed=0,
                              assess_backend=_backend(backend))
    assert len(meta["runs"]) == 3 * (len(RD.CORPUS_RUNS) + 1)
    assert _sha(port) == _sha(ref_corpus)
    corpus = PD.load_corpus(str(port))
    assert corpus["meta"] == meta
    tr, ev = PD.train_eval_split(meta["n_rows"], seed=0)
    rtr, rev = RD.train_eval_split(meta["n_rows"], seed=0)
    np.testing.assert_array_equal(tr, rtr)
    np.testing.assert_array_equal(ev, rev)


# ---------------------------------------------------------------------------
# 3. Model and checkpoints
# ---------------------------------------------------------------------------
def _random_params(seed=0, n=PF.N_FEATURES, hidden=16):
    rng = np.random.default_rng(seed)
    return {"w0": rng.normal(size=(n, hidden)),
            "b0": rng.normal(size=hidden),
            "w1": rng.normal(size=(hidden, 1)),
            "b1": rng.normal(size=1),
            "mu": rng.normal(size=n),
            "sd": rng.uniform(0.5, 2.0, size=n)}


def test_forward_equal_reference():
    import jax.numpy as jnp

    params = _random_params()
    X = np.random.default_rng(1).normal(size=(64, PF.N_FEATURES))
    np.testing.assert_array_equal(PM.forward_np(params, X),
                                  RM.forward_np(params, X))
    np.testing.assert_array_equal(PM.scores_np(params, X),
                                  RM.scores_np(params, X))
    for k in ("w0", "b0", "w1", "b1", "mu", "sd"):
        np.testing.assert_array_equal(PM.default_params()[k],
                                      RM.default_params()[k])
    # the training forward in float32, against numpy's float64 and JAX's
    tparams = PM.from_jax_params(params, device="cpu")
    assert all(v.dtype == torch.float32 for v in tparams.values())
    got = PM.forward_torch(tparams, torch.tensor(X, dtype=torch.float32))
    want = RM.forward_jax({k: jnp.asarray(v, jnp.float32)
                           for k, v in params.items()},
                          jnp.asarray(X, jnp.float32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got.numpy(), PM.forward_np(params, X),
                               rtol=1e-5, atol=1e-5)


def test_init_params_distributions():
    p = PM.init_params(0, device="cpu")
    assert {k: tuple(v.shape) for k, v in p.items()} == {
        "w0": (PF.N_FEATURES, 16), "b0": (16,), "w1": (16, 1), "b1": (1,),
        "mu": (PF.N_FEATURES,), "sd": (PF.N_FEATURES,)}
    assert all(v.dtype == torch.float32 for v in p.values())
    again = PM.init_params(0, device="cpu")
    assert all(torch.equal(p[k], again[k]) for k in p)
    assert not torch.equal(p["w0"], PM.init_params(1, device="cpu")["w0"])
    assert not (p["b0"].any() or p["b1"].any() or p["mu"].any())
    assert torch.equal(p["sd"], torch.ones(PF.N_FEATURES))
    # fan-in normals: std shape[0] ** -0.5
    assert abs(float(p["w0"].std()) * PF.N_FEATURES ** 0.5 - 1.0) < 0.2


def test_checkpoints_cross_read(ref_corpus, ref_ckpt, tmp_path):
    port_dir = str(tmp_path / "port")
    meta = PT.train(ref_corpus, port_dir, seed=0, steps=20, device="cpu")
    for path in (ref_ckpt[20], port_dir):
        got, want = PM.load_params_np(path), RM.load_params_np(path)
        assert sorted(got) == sorted(want) == sorted(
            PM.TRAINED_LEAVES + PM.FROZEN_LEAVES)
        for k in want:
            assert got[k].dtype == np.float64
            np.testing.assert_array_equal(got[k], want[k])
        assert PM.checkpoint_metadata(path) == RM.checkpoint_metadata(path)
        pol = PredictorPolicy(["n0", "n1"], assess_backend="numpy")
        pol.load_checkpoint(path)
        assert pol.cfg.threshold == RM.checkpoint_metadata(path)["threshold"]
        assert pol.params["w0"].shape == (PF.N_FEATURES, 16)
    assert RM.checkpoint_metadata(port_dir) == meta
    # the same metadata keys as the reference's
    assert sorted(meta) == sorted(RM.checkpoint_metadata(ref_ckpt[20]))


# ---------------------------------------------------------------------------
# 4. Training from the reference's initial weights
# ---------------------------------------------------------------------------
@pytest.fixture
def ref_init(monkeypatch):
    def init(seed, n_features=PF.N_FEATURES, hidden=16, *, device="cuda"):
        params = RM.init_params(seed, n_features, hidden)
        return PM.from_jax_params({k: np.asarray(v)
                                   for k, v in params.items()},
                                  device=device)
    monkeypatch.setattr(PT, "init_params", init)


def test_train_matches_reference_20_steps(ref_corpus, ref_ckpt, ref_init,
                                          tmp_path):
    meta = PT.train(ref_corpus, str(tmp_path / "p"), seed=0, steps=20,
                    device="cpu")
    want_meta = RM.checkpoint_metadata(ref_ckpt[20])
    assert abs(meta["final_train_loss"]
               - want_meta["final_train_loss"]) <= 1e-6
    assert meta["threshold"] == want_meta["threshold"]
    assert meta["split"] == want_meta["split"]
    assert meta["pos_weight"] == want_meta["pos_weight"]
    got = PM.load_params_np(str(tmp_path / "p"))
    want = RM.load_params_np(ref_ckpt[20])
    for k in PM.TRAINED_LEAVES:
        err = np.linalg.norm(got[k] - want[k]) / np.linalg.norm(want[k])
        assert err <= 1e-5, (k, err)
    for k in PM.FROZEN_LEAVES:
        np.testing.assert_array_equal(got[k], want[k])


def test_train_matches_reference_400_steps(ref_corpus, ref_ckpt, ref_init,
                                           tmp_path):
    meta = PT.train(ref_corpus, str(tmp_path / "p"), seed=0, device="cpu")
    want = RM.checkpoint_metadata(ref_ckpt[400])
    assert meta["steps"] == want["steps"] == 400
    assert abs(meta["threshold"] - want["threshold"]) <= 0.05 + 1e-12
    assert abs(meta["final_train_loss"] - want["final_train_loss"]) \
        <= 0.01 * want["final_train_loss"]


# ---------------------------------------------------------------------------
# 5. The policy in the simulator
# ---------------------------------------------------------------------------
def _run(pkg, mode, *, params=None, ckpt=None, obs=None, checks=(),
         script=CRASH_AT_20, **kw):
    """tests/test_predict.py's predictor run, for either package."""
    sim = pkg.Simulation(policy="predictor", seed=1, shuffle=mode,
                         record_actions=True, obs=obs, **kw)
    if params is not None:
        sim.speculator.params = params
    if ckpt is not None:
        sim.speculator.load_checkpoint(ckpt)
    launches = []
    orig = sim._start_attempt

    def logged(req, node_id):
        launches.append((sim.engine.now, req.task.task_id, node_id,
                         req.reason, req.speculative, req.rollback))
        return orig(req, node_id)

    sim._start_attempt = logged
    job = sim.submit(pkg.JobSpec("j0", "terasort", 2.0))
    if script:
        pkg.faults.apply_script(sim, job, script)
    for t in checks:
        sim.engine.at(float(t), sim.verify_arrays)
    results = sim.run()
    key = [(r.job_id, r.finish_time, r.n_attempts, r.n_spec_attempts,
            r.n_fetch_failures) for r in results]
    return sim.action_trace, launches, key


@pytest.mark.parametrize("net", ["default", "fire", "trained"])
@pytest.mark.parametrize("backend", ["numpy", "torch-cpu"])
def test_predictor_traces_equal_reference(backend, net, ref_ckpt):
    kw = {"params": fire_params()} if net == "fire" else \
        {"ckpt": ref_ckpt[400]} if net == "trained" else {}
    for mode in SHUFFLES:
        want = _run(ref_sim, mode, **kw)
        got = _run(port_sim, mode, assess_backend=_backend(backend), **kw)
        assert got == want, mode
        if net == "fire":
            assert any(x[4] for x in got[1]), "the fire net speculated none"
        if net == "default":
            assert not any(x[4] for x in got[1])


def test_predictor_obs_identity():
    base = _run(port_sim, "event", params=fire_params(),
                assess_backend="numpy")
    observed = _run(port_sim, "event", params=fire_params(),
                    assess_backend="numpy", obs=TraceRecorder(),
                    checks=(25.0, 45.0))
    assert base == observed
    assert any(x[4] for x in base[1])


def test_predictor_requires_columnar():
    with pytest.raises(ValueError, match="columnar"):
        port_sim.Simulation(policy="predictor", columnar=False,
                            assess_backend="numpy")


def test_fig_predictor_scenarios_equal_reference(ref_ckpt):
    """chip_smoke.py's fig_predictor runs (its copy of the benchmark's
    scenarios) on the port give the benchmark's numbers on the
    reference, for one checkpoint."""
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
        from benchmarks import fig_predictor as FIG
    finally:
        sys.path.remove(str(ROOT))
    assert chip_smoke.FIG_PREDICTOR_SCENARIOS == FIG.SCENARIOS
    assert chip_smoke.FIG_PREDICTOR_SEED == FIG.SEED
    assert chip_smoke.FIG_PREDICTOR_POLICIES == FIG.POLICIES
    for name, (script, kw) in FIG.SCENARIOS.items():
        for policy in FIG.POLICIES:
            got = chip_smoke._fig_predictor_run(policy, script, kw,
                                                ref_ckpt[400], "numpy")
            want = FIG._run_scenario(policy, script, kw, ref_ckpt[400])
            assert got == {k: want[k] for k in got}, (name, policy)


@pytest.mark.parametrize("net,fails", [
    ("default", "predictor recall below bino's"),
    ("fire", "wastes more backups per straggler than yarn")])
def test_fig_predictor_bars_reject_probes(net, fails, tmp_path):
    """chip_smoke.py's two bars fail a net that never speculates (it
    misses the slow node) and one that always does."""
    from repro_torch.checkpoint.manager import CheckpointManager

    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    params = fire_params() if net == "fire" else RM.default_params()
    CheckpointManager(str(tmp_path), keep=1).save(params, 0, metadata={})
    with pytest.raises(RuntimeError, match=fails):
        chip_smoke.fig_predictor_bars(str(tmp_path), "numpy")


def test_runtime_skips_ref_shadow_for_learned_policy():
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.runtime import FakeClock, RuntimeConfig, TrainerRuntime
    from repro_torch.train.loop import TrainConfig

    def factory(host_ids):
        return PredictorPolicy(host_ids, total_slots=8,
                               assess_backend="numpy")

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for spec_factory, expect_shadow in ((factory, False), (None, True)):
            rt = RuntimeConfig(n_hosts=4, microbatches_per_shard=4,
                               recovery="bino", compute_delay=0.02,
                               verify_columnar=True, assess_backend="numpy",
                               speculator_factory=spec_factory)
            t = TrainerRuntime(reduced_config(get_config("qwen1.5-0.5b")),
                               TrainConfig(), rt, seq_len=32,
                               per_shard_batch=2, seed=0,
                               clock=FakeClock(auto_advance=True),
                               device="cpu")
            try:
                assert (t.coord._ref_spec is not None) == expect_shadow
                if spec_factory is not None:
                    assert isinstance(t.coord.speculator, PredictorPolicy)
                assert len(t.run(2)) == 2
            finally:
                t.shutdown()
    finally:
        torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# 6. Defaults: the card
# ---------------------------------------------------------------------------
def test_defaults_are_the_card(monkeypatch, tmp_path, ref_corpus):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: PredictorPolicy(["n0"]),
                 lambda: port_sim.Simulation(policy="predictor"),
                 lambda: PD.generate_corpus(str(tmp_path / "c.npz"),
                                            runs=SMALL_RUNS),
                 lambda: PM.init_params(0),
                 lambda: PM.from_jax_params(RM.default_params()),
                 lambda: PT.train(ref_corpus, str(tmp_path / "ck"))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    assert not (tmp_path / "c.npz").exists()


def test_chip_smoke_predictor_path_rehearses_on_cpu(tmp_path, capsys):
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    out = chip_smoke.predictor_path(
        device="cpu", workdir=str(tmp_path), corpus_runs=SMALL_RUNS,
        n_workers=60, n_jobs=3, gb=4.0, cap=120.0)
    assert sorted(out) == ["corpus", "policy"]   # the bars need the card
    assert not any(out["corpus"].values())   # plain versions: no launch
    assert not any(out["policy"].values())
    text = capsys.readouterr().out
    assert "files byte-identical, card vs numpy" in text
    assert "predictor policy: identical traces" in text
    assert text.count("predictor train") == 2
    assert not list(tmp_path.iterdir())       # files removed
