"""The port's manifest checkpoints and restart supervisor, on the CPU:
the reference's own checks (``tests/test_system.py``) run through the
port, checkpoints crossing between the two packages bit for bit (float32
and int32 leaves), a bf16 round trip, asynchronous saves, uncommitted
directories ignored, the coordinator's decisions equal to the
reference's, and ``launch.train`` resuming from its own checkpoint."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt.manifest import CheckpointManager as JaxCheckpointManager
from repro.runtime import coordinator as jcoord
from repro_torch.ckpt.manifest import CheckpointManager, flatten_tree
from repro_torch.runtime import coordinator as coord
from repro_torch.runtime.coordinator import (
    ElasticPlanner,
    MeshTemplate,
    TrainSupervisor,
)


def test_checkpoint_restart_equivalence(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = {"a": torch.arange(6.0).reshape(2, 3), "b": torch.zeros((4,))}
    for step in (1, 2, 3):
        mgr.save(step, {k: v + step for k, v in tree.items()}, blocking=True)
    assert mgr.latest_step() == 3
    restored = mgr.restore(3, like=tree)
    np.testing.assert_allclose(restored["a"].numpy(),
                               np.arange(6.0).reshape(2, 3) + 3)
    # keep=2 garbage-collected step 1
    assert not (tmp_path / "step_000000001").exists()
    assert (tmp_path / "step_000000002" / "COMMITTED").exists()


def test_supervisor_failure_restart(tmp_path):
    """Host failure mid-training -> restore from checkpoint -> rescale."""
    mgr = CheckpointManager(str(tmp_path))
    planner = ElasticPlanner(MeshTemplate(data=8, model=4))
    fail_at = {"step": 13, "done": False}

    def step_fn(state, step, plan):
        if step == fail_at["step"] and not fail_at["done"]:
            fail_at["done"] = True
            raise TrainSupervisor.HostFailure("host3")
        return {"w": state["w"] + 1.0}

    sup = TrainSupervisor(planner, mgr, lambda: {"w": torch.zeros(())},
                          step_fn, ckpt_every=5)
    state, info = sup.run(target_steps=20, total_hosts=8)
    assert info["restarts"] == 1
    assert info["final_step"] == 20
    assert float(state["w"]) == 20.0  # resumed from step-10 ckpt, re-ran 10..20
    kinds = [e["kind"] for e in info["events"]]
    assert "failure" in kinds and "rescale" in kinds
    assert info["plan"].new_data == 4  # shrunk to the power-of-two <= 7 hosts


def test_coordinator_decisions_equal_the_reference():
    """Planner, heartbeats and straggler flags: the same answers as the
    reference's classes on the same inputs."""
    for data, model, pods, per in ((8, 4, 1, 1), (16, 16, 2, 2), (4, 2, 1, 3)):
        for alive in range(0, 40, 3):
            a = coord.ElasticPlanner(coord.MeshTemplate(data, model, pods, per))
            b = jcoord.ElasticPlanner(jcoord.MeshTemplate(data, model, pods,
                                                          per))
            pa, pb = a.plan(alive, ("h1",)), b.plan(alive, ("h1",))
            assert (pa is None) == (pb is None)
            if pa is not None:
                assert pa.mesh_shape == pb.mesh_shape
                assert (pa.batch_scale, pa.needs_reshard, pa.dropped_hosts) \
                    == (pb.batch_scale, pb.needs_reshard, pb.dropped_hosts)
    clock = {"t": 0.0}
    now = lambda: clock["t"]  # noqa: E731
    hosts = ["h0", "h1", "h2"]
    ta, tb = (m.HeartbeatTracker(hosts, 5.0, now) for m in (coord, jcoord))
    sa, sb = coord.StragglerMonitor(), jcoord.StragglerMonitor()
    for t in range(12):
        clock["t"] = float(t)
        for tr in (ta, tb):
            tr.beat("h0")
            if t < 4:
                tr.beat("h1")
        for i, h in enumerate(hosts):
            for s in (sa, sb):
                s.record(h, 1.0 + (i == 2) * t * 0.3)
        assert ta.failed() == tb.failed() and ta.alive() == tb.alive()
        assert sa.stragglers() == sb.stragglers()
    assert ta.failed() == ["h1", "h2"]
    assert sa.stragglers() == ["h2"]


def _bytes(a):
    return np.ascontiguousarray(np.asarray(a)).reshape(-1).view(np.uint8)


def _mixed_tree(rng):
    return {"w": rng.normal(size=(3, 5)).astype(np.float32),
            "n": {"i": rng.integers(-9, 9, (7,)).astype(np.int32),
                  "z": np.float32(2.5)},
            "step": np.int32(11)}


def test_checkpoints_cross_between_packages_bit_for_bit(tmp_path):
    rng = np.random.default_rng(0)
    tree = _mixed_tree(rng)
    # JAX writes, the port reads
    JaxCheckpointManager(str(tmp_path / "j")).save(
        4, {k: (jnp.asarray(v) if not isinstance(v, dict) else
                {kk: jnp.asarray(vv) for kk, vv in v.items()})
            for k, v in tree.items()}, blocking=True)
    got = CheckpointManager(str(tmp_path / "j")).restore(like=tree)
    for (p, a), (q, b) in zip(flatten_tree(tree), flatten_tree(got)):
        assert p == q
        assert b.numpy().dtype == np.asarray(a).dtype
        np.testing.assert_array_equal(_bytes(b.numpy()), _bytes(a))
    # the port writes, JAX reads: the same manifest and leaf files
    t_tree = {"w": torch.from_numpy(tree["w"]),
              "n": {"i": torch.from_numpy(tree["n"]["i"]),
                    "z": torch.tensor(2.5)},
              "step": torch.tensor(11, dtype=torch.int32)}
    CheckpointManager(str(tmp_path / "t")).save(4, t_tree, blocking=True)
    back = JaxCheckpointManager(str(tmp_path / "t")).restore(4, like=tree)
    for (p, a), (_, b) in zip(flatten_tree(tree), flatten_tree(back)):
        assert np.asarray(b).dtype == np.asarray(a).dtype, p
        np.testing.assert_array_equal(_bytes(b), _bytes(a))
    mj = json.loads((tmp_path / "j" / "step_000000004" / "manifest.json")
                    .read_text())
    mt = json.loads((tmp_path / "t" / "step_000000004" / "manifest.json")
                    .read_text())
    assert mt["leaves"] == mj["leaves"] and mt["step"] == mj["step"] == 4
    assert mt["treedef"] is None


def test_bf16_round_trip_and_async_snapshot(tmp_path):
    g = torch.Generator().manual_seed(1)
    w = torch.randn((33, 17), generator=g).to(torch.bfloat16)
    tree = {"w": w, "m": torch.randn((5,), generator=g)}
    mgr = CheckpointManager(str(tmp_path), keep=5)
    mgr.save(1, tree, blocking=False)
    saved = {k: v.clone() for k, v in tree.items()}
    w.add_(1.0)  # a later in-place step cannot reach the snapshot
    mgr.wait()
    man = mgr.manifest(1)
    assert [leaf["dtype"] for leaf in man["leaves"]] == ["float32", "bfloat16"]
    got = mgr.restore(1, like=tree)
    assert got["w"].dtype == torch.bfloat16
    for k in tree:
        assert torch.equal(got[k].view(torch.int16) if k == "w" else got[k],
                           saved[k].view(torch.int16) if k == "w" else saved[k])
    with pytest.raises(ValueError, match="leaves"):
        mgr.restore(1, like={"other": w})


def test_uncommitted_directories_are_ignored(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.latest_step() is None
    with pytest.raises(FileNotFoundError):
        mgr.restore(like={"a": torch.zeros(1)})
    mgr.save(2, {"a": torch.ones(1)})
    # a crash mid-save leaves a .tmp directory, or a renamed one without
    # COMMITTED: neither is a checkpoint
    (tmp_path / ".tmp-step_000000009").mkdir()
    (tmp_path / "step_000000007").mkdir()
    assert mgr.latest_step() == 2
    assert float(mgr.restore(like={"a": torch.zeros(1)})["a"]) == 1.0


def test_launch_train_resumes_from_its_checkpoint(tmp_path, capsys):
    """``launch.train --ckpt-dir`` then ``--restore``: the restored
    parameters and optimizer state equal the saved ones, and the run
    continues from the next step."""
    from repro_torch.ckpt.manifest import CheckpointManager as M
    from repro_torch.launch import train

    args = ["--arch", "featinsight-fraud", "--smoke", "--steps", "6",
            "--batch", "2", "--seq", "16", "--ckpt-every", "3",
            "--ckpt-dir", str(tmp_path), "--device", "cpu"]
    first = train.main(args)
    saved = [t.clone() for _, t in flatten_tree(
        train.checkpoint_tree(first["model"], first["opt"]))]
    assert M(str(tmp_path)).latest_step() == 5
    second = train.main(args[:4] + ["8"] + args[5:] + ["--restore"])
    assert "restored checkpoint step 5" in capsys.readouterr().out
    assert len(second["losses"]) == 2
    from repro_torch.models import build_model

    model = build_model(first["cfg"], seed=7, device="cpu")
    opt = train.restore_state(M(str(tmp_path)), 5, model, "cpu")
    again = [t for _, t in flatten_tree(train.checkpoint_tree(model, opt))]
    assert all(torch.equal(a, b) for a, b in zip(saved, again))
    with pytest.raises(SystemExit, match="TPU mesh"):
        train.main(["--arch", "featinsight-fraud", "--dry-run"])
