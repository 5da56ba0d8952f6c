"""`repro_torch.checkpoint`, `repro_torch.runtime` and
`repro_torch.launch.train` on the CPU: the JAX package's
tests/test_runtime.py cases ported, the port's own cases (the async
snapshot copies, bf16 bit-exact, reshard's refusal), checkpoints across
the two packages, and `run_resilient_loop` against the reference's.

Tolerances (stated before the first run): restored leaves, histories,
steps and saved steps exact; the two loops' losses within 1e-4 relative,
step by step (f32 on both sides, the port's eager step against the
reference's jit'd one).
"""

import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JaxCheckpointManager
from repro.checkpoint import restore as jax_restore
from repro.checkpoint import save as jax_save
from repro.configs import get_config as jax_get_config
from repro.data.tokens import TokenPipeline as JaxTokenPipeline
from repro.runtime import RecoveryPolicy as JaxRecoveryPolicy
from repro.runtime import run_resilient_loop as jax_run_resilient_loop
from repro.train import init_train_state as jax_init_train_state
from repro.train.train_step import make_train_step as jax_make_train_step
from repro_torch.checkpoint import (CheckpointManager, latest_step, restore,
                                    save)
from repro_torch.checkpoint import checkpoint as checkpoint_module
from repro_torch.configs import get_config
from repro_torch.data.tokens import TokenPipeline
from repro_torch.launch import train as train_launcher
from repro_torch.models.interop import params_from_jax
from repro_torch.models.model import tree_leaves_with_path
from repro_torch.optim.adamw import tree_leaves
from repro_torch.runtime import RecoveryPolicy, StepMonitor, run_resilient_loop
from repro_torch.runtime.elastic import plan_mesh, reshard
from repro_torch.train import init_train_state
from repro_torch.train.train_step import make_train_step

LOSS_RTOL = 1e-4


def _tiny_setup(steps=30):
    cfg = get_config("qwen3-0.6b").reduced()
    pipe = TokenPipeline(vocab_size=cfg.vocab_size, batch_size=4,
                         seq_len=32, seed=1)
    state = init_train_state(cfg, 0, device="cpu").tree()
    step_fn = make_train_step(cfg, num_microbatches=1, peak_lr=1e-3,
                              compute_dtype=torch.float32, total_steps=steps)

    def data_fn(step):
        toks = torch.as_tensor(pipe.batch(step)["tokens"])
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    return cfg, state, step_fn, data_fn


def _assert_trees_equal(a, b):
    fa, fb = dict(tree_leaves_with_path(a)), dict(tree_leaves_with_path(b))
    assert sorted(fa) == sorted(fb)
    for path, x in fa.items():
        y = fb[path]
        assert (x.dtype, x.device, x.shape) == (y.dtype, y.device, y.shape), \
            path
        assert torch.equal(x, y), path


# ---- the reference's tests/test_runtime.py cases ----

def test_checkpoint_roundtrip_and_atomicity():
    cfg, state, _, _ = _tiny_setup()
    with tempfile.TemporaryDirectory() as d:
        save(d, 3, state, metadata={"note": "x"})
        assert latest_step(d) == 3
        restored, meta = restore(d, state)
        assert meta["step"] == 3 and meta["note"] == "x"
        _assert_trees_equal(state, restored)
        assert restored["opt"]["step"].shape == ()
        # No .tmp residue (atomic rename).
        assert not [f for f in os.listdir(d) if f.endswith(".tmp")]
        assert sorted(os.listdir(os.path.join(d, "step_00000003"))) \
            == ["arrays.npz", "meta.json"]


def test_checkpoint_manager_retention_and_async():
    cfg, state, _, _ = _tiny_setup()
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d, keep_last=2)
        for s in (1, 2, 3, 4):
            mgr.save(s, state)
        mgr.wait()
        assert latest_step(d, all_steps=True) == [3, 4]
        assert [e["step"] for e in mgr.events] == [1, 2, 3, 4]
        assert all(e["write_s"] >= 0 and e["snapshot_s"] >= 0
                   for e in mgr.events)


def test_checkpoint_template_mismatch_fails_loudly():
    with tempfile.TemporaryDirectory() as d:
        save(d, 0, {"a": torch.zeros(3)})
        with pytest.raises(ValueError, match="mismatch") as err:
            restore(d, {"b": torch.zeros(3)})
        assert "missing=['b']" in str(err.value) \
            and "extra=['a']" in str(err.value)
        with pytest.raises(FileNotFoundError):
            restore(os.path.join(d, "none"), {"a": torch.zeros(3)})


def test_recovery_loop_rolls_back_on_nan():
    cfg, state, step_fn, data_fn = _tiny_setup()
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d, keep_last=3)
        state, hist = run_resilient_loop(
            state, step_fn, data_fn, num_steps=24, manager=mgr,
            policy=RecoveryPolicy(ckpt_every=8),
            fail_at={13}, log=lambda s: None)
        assert hist["rollbacks"] == 1
        assert hist["skipped"] == [13]
        assert len(hist["loss"]) >= 22  # all steps except the faulty one
        assert all(np.isfinite(l) for l in hist["loss"])
        assert int(state["opt"]["step"]) == 23
        assert latest_step(d, all_steps=True) == [8, 16, 24]


def test_recovery_loop_gives_up_after_max_rollbacks():
    cfg, state, step_fn, data_fn = _tiny_setup()
    with tempfile.TemporaryDirectory() as d:
        with pytest.raises(RuntimeError, match="rollbacks"):
            run_resilient_loop(
                state, step_fn, data_fn, num_steps=6,
                manager=CheckpointManager(d),
                policy=RecoveryPolicy(ckpt_every=2, max_rollbacks=1,
                                      skip_bad_step=False),
                fail_at={1, 3}, log=lambda s: None)


def test_straggler_monitor_flags_and_evicts():
    mon = StepMonitor(threshold=2.0, window=16, max_strikes=2, num_hosts=4)
    for i in range(10):
        mon.stop(i, host=0, duration=1.0)
    assert mon.stop(10, host=3, duration=5.0) is not None
    assert mon.stop(11, host=3, duration=4.5) is not None
    assert mon.hosts_to_evict() == [3]
    assert mon.stop(12, host=1, duration=1.1) is None
    with pytest.raises(RuntimeError):
        StepMonitor().stop(0)


def test_elastic_remesh_and_reshard():
    cfg, state, _, _ = _tiny_setup()
    mesh = plan_mesh(1, model_parallel=1, device="cpu")
    assert mesh.shape == {"data": 1, "model": 1}
    params2 = reshard(state["params"], mesh)
    _assert_trees_equal(state["params"], params2)
    pods = plan_mesh(4, model_parallel=2, pods=2, device="cpu")
    assert pods.shape == {"pod": 2, "data": 1, "model": 2}
    with pytest.raises(ValueError, match="model_parallel"):
        plan_mesh(8, model_parallel=16, device="cpu")


# ---- the port's own cases ----

def test_async_save_snapshots_before_in_place_updates():
    """The port's AdamW writes in place; a state mutated after
    save(blocking=False) and before wait() restores to its values at the
    save."""
    cfg, state, step_fn, data_fn = _tiny_setup()
    before = {p: t.clone() for p, t in tree_leaves_with_path(state)}
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d)
        mgr.save(0, state)
        step_fn(state, data_fn(0))          # in place
        with torch.no_grad():
            for t in tree_leaves(state["params"]):
                t.add_(1.0)
        mgr.wait()
        restored, _ = restore(d, state)
    assert int(state["opt"]["step"]) == 1
    for path, t in tree_leaves_with_path(restored):
        assert torch.equal(t, before[path]), path


def test_bf16_leaves_round_trip_bit_exact():
    g = torch.Generator().manual_seed(3)
    x = torch.randn(5, 7, generator=g).to(torch.bfloat16)
    x[0, :4] = torch.tensor([float("inf"), -0.0, float("nan"), 1e-40])
    tree = {"w": x, "m": torch.randn(4, generator=g),
            "step": torch.tensor(9, dtype=torch.int32)}
    with tempfile.TemporaryDirectory() as d:
        CheckpointManager(d).save(2, tree, blocking=True)
        with np.load(os.path.join(d, "step_00000002", "arrays.npz")) as f:
            assert f["w"].dtype == np.uint16
        back, meta = restore(d, tree)
    assert meta["dtypes"] == {"w": "bfloat16"}
    assert back["w"].dtype == torch.bfloat16
    assert torch.equal(back["w"].view(torch.int16), x.view(torch.int16))
    assert torch.equal(back["m"], tree["m"]) and back["step"].shape == ()


def test_restore_places_by_shardings_and_template():
    tree = {"a": torch.arange(6.0).reshape(2, 3), "n": torch.tensor(4)}
    with tempfile.TemporaryDirectory() as d:
        save(d, 1, tree)
        got, _ = restore(d, {"a": torch.zeros(2, 3, dtype=torch.float64),
                             "n": torch.zeros((), dtype=torch.int64)})
        assert got["a"].dtype == torch.float64 and torch.equal(
            got["a"], tree["a"].double())
        placed, _ = restore(d, tree, shardings={"a": torch.device("cpu"),
                                                "n": torch.device("meta")})
    assert placed["a"].device.type == "cpu"
    assert placed["n"].device.type == "meta"


def test_restore_reads_members_as_np_load_and_checks_their_crc():
    """The parallel reader gives what `np.load` gives (0-d, empty, 3-d,
    Fortran-ordered, bf16 bits), and refuses a compressed archive and a member whose bytes
    no longer match its CRC."""
    tree = {"w": torch.randn(3, 4, 5), "e": torch.zeros(0, 7),
            "t": torch.randn(4, 6).t(),
            "b": torch.randn(9, dtype=torch.bfloat16),
            "n": torch.tensor(11, dtype=torch.int32)}
    with tempfile.TemporaryDirectory() as d:
        save(d, 2, tree)
        npz = os.path.join(d, "step_00000002", "arrays.npz")
        with np.load(npz) as data:
            want = {k: data[k] for k in data.files}
        assert not want["t"].flags.c_contiguous
        got = checkpoint_module._load_npz(npz)
        assert sorted(got) == sorted(want)
        for k, a in want.items():
            assert (got[k].dtype, got[k].shape) == (a.dtype, a.shape), k
            np.testing.assert_array_equal(got[k], a)
        back, _ = restore(d, tree)
        _assert_trees_equal(tree, back)

        np.savez_compressed(npz, **want)
        with pytest.raises(ValueError, match="compressed"):
            restore(d, tree)

        np.savez(npz, **want)
        raw = bytearray(open(npz, "rb").read())
        at = raw.index(want["w"].tobytes()[:16])
        raw[at] ^= 1
        with open(npz, "wb") as f:
            f.write(raw)
        with pytest.raises(ValueError, match="CRC"):
            restore(d, tree)


def test_checkpoints_cross_between_the_packages():
    """An f32 / int train state written by the reference's `save` restores
    in the port equal to `params_from_jax` of that tree; one written by the
    port restores in the reference's `restore`."""
    jcfg = jax_get_config("qwen3-0.6b").reduced()
    jstate = jax_init_train_state(jcfg, jax.random.PRNGKey(0)).tree()
    jnp_tree = jax.tree.map(np.asarray, jstate)
    want = params_from_jax(jnp_tree)
    template = init_train_state(get_config("qwen3-0.6b").reduced(), 5,
                                device="cpu").tree()
    with tempfile.TemporaryDirectory() as d:
        jax_save(d, 4, jstate)
        got, meta = restore(d, template)
        assert meta["step"] == 4
        _assert_trees_equal(want, got)
    with tempfile.TemporaryDirectory() as d:
        save(d, 6, want)
        back, meta = jax_restore(d, jnp_tree)
        assert meta["step"] == 6
        for a, b in zip(jax.tree.leaves(jnp_tree), jax.tree.leaves(back)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_reshard_refuses_to_split_a_leaf():
    cfg, state, _, _ = _tiny_setup()
    for mesh in (plan_mesh(2, model_parallel=1, device="cpu"),
                 plan_mesh(2, model_parallel=2, device="cpu")):
        with pytest.raises(NotImplementedError, match="leaf embed/table"):
            reshard(state["params"], mesh)
    # A leaf whose spec splits over no axis of size > 1 is placed whole.
    norm = {"final_norm": {"scale": torch.ones(64)}}
    placed = reshard(norm, plan_mesh(2, model_parallel=2, device="cpu"))
    assert torch.equal(placed["final_norm"]["scale"], torch.ones(64))


def _jax_tiny(steps):
    cfg = jax_get_config("qwen3-0.6b").reduced()
    pipe = JaxTokenPipeline(vocab_size=cfg.vocab_size, batch_size=4,
                            seq_len=32, seed=1)
    state = jax_init_train_state(cfg, jax.random.PRNGKey(0)).tree()
    step_fn = jax.jit(jax_make_train_step(cfg, num_microbatches=1,
                                          peak_lr=1e-3,
                                          compute_dtype=jnp.float32,
                                          total_steps=steps))

    def data_fn(step):
        toks = jnp.asarray(pipe.batch(step)["tokens"])
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    return state, step_fn, data_fn


def test_resilient_loop_matches_the_reference():
    """qwen3-0.6b reduced, f32, the same carried-over state, 10 steps,
    ckpt_every=4, a NaN injected at step 6: the same rollbacks, skipped
    steps, number of losses and saved steps; losses within 1e-4 relative."""
    jstate, jstep, jdata = _jax_tiny(10)
    _, _, step_fn, data_fn = _tiny_setup(10)
    state = params_from_jax(jax.tree.map(np.asarray, jstate))
    quiet = {"log": lambda s: None}
    with tempfile.TemporaryDirectory() as jd, \
            tempfile.TemporaryDirectory() as d:
        _, jhist = jax_run_resilient_loop(
            jstate, jstep, jdata, num_steps=10,
            manager=JaxCheckpointManager(jd, keep_last=10),
            policy=JaxRecoveryPolicy(ckpt_every=4), fail_at={6}, **quiet)
        state, hist = run_resilient_loop(
            state, step_fn, data_fn, num_steps=10,
            manager=CheckpointManager(d, keep_last=10),
            policy=RecoveryPolicy(ckpt_every=4), fail_at={6}, **quiet)
        assert latest_step(d, all_steps=True) \
            == latest_step(jd, all_steps=True) == [0, 4, 8, 10]
    assert hist["rollbacks"] == jhist["rollbacks"] == 1
    assert hist["skipped"] == jhist["skipped"] == [6]
    assert len(hist["loss"]) == len(jhist["loss"]) == 11
    np.testing.assert_allclose(hist["loss"], jhist["loss"], rtol=LOSS_RTOL,
                               atol=0)
    assert int(state["opt"]["step"]) == 9


def test_train_launcher_fresh_then_resumed(capsys):
    base = ["--arch", "qwen3-0.6b", "--reduced", "--device", "cpu",
            "--global-batch", "4", "--seq", "32", "--microbatches", "2"]
    with tempfile.TemporaryDirectory() as d:
        state, hist = train_launcher.main(base + ["--steps", "3",
                                                  "--ckpt-dir", d])
        assert hist["start_step"] == 0 and len(hist["loss"]) == 3
        assert int(state["opt"]["step"]) == 3
        assert latest_step(d, all_steps=True) == [0, 3]
        saved, _ = restore(d, state)
        _assert_trees_equal(state, saved)
        state, hist = train_launcher.main(base + ["--steps", "5",
                                                  "--ckpt-dir", d])
        assert hist["start_step"] == 3 and len(hist["loss"]) == 2
        assert int(state["opt"]["step"]) == 5
        assert all(np.isfinite(hist["loss"]))
        assert latest_step(d, all_steps=True) == [0, 3, 5]
        assert [e["op"] for e in hist["checkpoints"]] == ["restore", "save"]
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("[train] arch=qwen3-0.6b-smoke layers=")
    assert "[train] resumed from step 3" in out
    assert out[-1].startswith("[train] done: loss ")


def test_train_launcher_needs_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a CUDA device")
    with pytest.raises(RuntimeError, match="is_available"):
        train_launcher.main(["--arch", "qwen3-0.6b", "--reduced",
                             "--steps", "1"])
