"""The port's distributed sort, start-up and sharded checkpoints
(`spacetpu_torch.parallel.dsort`, `multihost`, `io/checkpoint`'s orbax
names, `parallel/dryrun`) on the CPU, in a gloo group of 4 real processes
formed by ``main --coordinator`` (`tests/torch_ranks.py`, one launch for
the session, shared with tests/test_torch_sharded.py), against numpy and
the JAX package's bitonic sort on 2 and 4 devices of the virtual mesh
(tests/test_dsort.py); the padded checkpoint of a ``--shard 4`` run
restored on one device (tests/test_engine.py:620-629); orbax-named
checkpoints over the whole group and over groups of 2; and the settings
of `multihost.initialize` without a launch."""

import functools
import json

import jax
import numpy as np
import pytest
import torch

from spacetpu.parallel import dsort as jdsort
from spacetpu.parallel import ring as jring
from spacetpu_torch import make_simulation
from spacetpu_torch.io import checkpoint as ck
from spacetpu_torch.parallel import multihost
from tests import torch_ranks
from tests.parity import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return torch_ranks.shared(tmp_path_factory)


def _jax_sort(keys, *payload, n_dev):
    spec = jax.sharding.PartitionSpec(jring.AXIS)
    f = jax.jit(jax.shard_map(
        functools.partial(jdsort.bitonic_sort_sharded, axis=jring.AXIS),
        mesh=jring.make_mesh(n_dev), in_specs=(spec,) * (1 + len(payload)),
        out_specs=(spec,) * (1 + len(payload)), check_vma=False))
    return [np.asarray(x) for x in f(keys, *payload)]


@pytest.mark.parametrize("name", ["d4", "d2a", "d2b"])
def test_bitonic_sorts_globally(ranks, name):
    """D = 4, and two groups of 2 side by side: the keys ascend across the
    ranks, each payload row rides with its key, and keys and payload are
    the JAX package's sort of the same shards, exactly."""
    group, seed, high, m = torch_ranks.SORTS[name]
    keys, vals = torch_ranks.sort_keys(len(group), seed, high, m)
    jk, jv = _jax_sort(keys, vals, n_dev=len(group))
    got = ranks.results()
    ks, vs, tag = (got[f"{name}_{f}"] for f in ("keys", "vals", "tag"))
    assert (np.diff(ks) >= 0).all()
    order = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(ks, keys[order])
    np.testing.assert_array_equal(vs, vals[tag])
    np.testing.assert_array_equal(ks, jk)
    np.testing.assert_array_equal(vs, jv)


def test_bitonic_duplicate_keys(ranks):
    """Keys in [0, 7) over 2,048 rows at D = 4: every row once (the
    canonical order of a merged pair keeps the two halves a partition),
    the keys those of a stable sort, the rows those of the JAX package."""
    group, seed, high, m = torch_ranks.SORTS["dup"]
    keys, _ = torch_ranks.sort_keys(len(group), seed, high, m)
    tag = np.arange(len(keys), dtype=np.int32)
    jk, jt = _jax_sort(keys, tag, n_dev=4)
    got = ranks.results()
    ks, ts = got["dup_keys"], got["dup_tag"]
    assert (np.diff(ks) >= 0).all()
    assert np.array_equal(np.sort(ts), tag)
    np.testing.assert_array_equal(ks, keys[np.argsort(keys, kind="stable")])
    np.testing.assert_array_equal(ks, jk)
    np.testing.assert_array_equal(ts, jt)


def test_bitonic_refuses_a_group_of_three(ranks):
    assert "power of 2, got 3" in ranks.results()["trio"]


def test_coordinator_run(ranks):
    """The group of the launch was formed by ``main --coordinator ...
    --num-processes 4 --process-id r`` alone (torchrun's variables
    removed): 4 processes, rank 0 printing the sharded run's lines."""
    got = ranks.results()
    assert got["world"] == 4 and got["index"] == 0
    lines = json.loads(got["lines"])["coordinator"]
    assert "sharding N=250 (padded to 252) over 4 devices (direct)" in lines
    assert any(s.startswith("2 steps of N=250 (padded 252) on 4 devices")
               for s in lines)


def test_sharded_checkpoint_restores_single_device(ranks, capsys):
    """The --shard 4 run's checkpoint holds the 252 padded rows and the
    250-body scene; restored on one device, main trims the zero-mass pad
    rows and runs on: bit for bit a single-device run from those rows."""
    from spacetpu_torch.main import main

    ranks.results()
    path = str(ranks.out_dir / "padded.npz")
    padded, scene, _ = ck.load(path, dtype=torch.float32, device="cpu")
    assert padded.n == 252 and scene.n == 250
    assert not padded.mass[250:].any()
    argv = [a for a in torch_ranks.COORD_ARGS if a not in ("--shard", "4")]
    final = main(argv + ["--restore", path])
    assert final.n == 250
    sim = make_simulation(250, algorithm="direct", eps=1e-2, g=scene.g,
                          device="cpu")
    start = padded._replace(
        **{f: getattr(padded, f)[:250] for f in
           ("pos", "vel", "mass", "acc", "pos_c", "vel_c")},
        n_active=torch.tensor(250, dtype=torch.int32))
    want = sim.run(sim.prime(start), 1e-3, 2)
    for f in ("pos", "vel", "pos_c", "vel_c"):
        assert torch.equal(getattr(final, f), getattr(want, f)), f


def test_orbax_sharded_roundtrip(ranks):
    """save_orbax of a sharded state: each of the 4 ranks writes and reads
    back its own rows (like= its shard), the extras beside; and the whole
    state reads back in one process, with and without like=."""
    got = ranks.results()
    assert got["orbax_same"]
    path = str(ranks.out_dir / "orbax_sharded")
    whole, extra = ck.load_orbax(path, device="cpu")
    assert extra == json.loads(got["orbax_extra"]) == {"steps": 3}
    np.testing.assert_array_equal(whole.pos.numpy(), got["orbax_pos"])
    np.testing.assert_array_equal(whole.vel_c.numpy(), got["orbax_vel_c"])
    again, _ = ck.load_orbax(path, like=whole)
    assert torch.equal(again.pos, whole.pos)
    assert again.n_active.dtype == torch.int32 and int(again.n_active) == 128


@pytest.mark.parametrize("pair", ["d2a", "d2b"])
def test_orbax_subgroup_roundtrip(ranks, pair):
    """save_orbax over a mesh of a group of 2 (ranks 0-1, and 2-3 beside
    them): the group's two ranks alone write and read back their halves,
    and the whole state reads back in one process."""
    got = ranks.results()
    assert got["orbax_pairs_same"]
    whole, extra = ck.load_orbax(str(ranks.out_dir / f"orbax_{pair}"),
                                 device="cpu")
    assert extra is None
    np.testing.assert_array_equal(whole.pos.numpy(), got["orbax_pos"])
    np.testing.assert_array_equal(whole.vel_c.numpy(), got["orbax_vel_c"])


def test_dryrun_rank_runs(ranks):
    assert ranks.results()["dryrun"]


def test_settings_resolution(monkeypatch):
    """initialize's settings: the arguments, else torchrun's variables,
    else the JAX package's names; none -> no group (False), and an address
    without a size refused (no discovery of a cluster)."""
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
              "LOCAL_RANK", "JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES",
              "JAX_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    assert multihost.settings() is None
    assert multihost.initialize() is False
    assert (multihost.process_index(), multihost.process_count(),
            multihost.is_coordinator()) == (0, 1, True)
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "h:1")
    monkeypatch.setenv("JAX_NUM_PROCESSES", "4")
    monkeypatch.setenv("JAX_PROCESS_ID", "3")
    assert multihost.settings() == {"address": "h:1", "world": 4, "rank": 3,
                                    "local": 0}
    monkeypatch.setenv("MASTER_ADDR", "t")
    monkeypatch.setenv("MASTER_PORT", "2")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert multihost.settings() == {"address": "t:2", "world": 2, "rank": 1,
                                    "local": 1}
    assert multihost.settings("a:9", 8, 5, [2]) == {
        "address": "a:9", "world": 8, "rank": 5, "local": 2}
    for k in ("MASTER_ADDR", "WORLD_SIZE", "RANK", "JAX_NUM_PROCESSES"):
        monkeypatch.delenv(k)
    with pytest.raises(ValueError, match="number of processes"):
        multihost.settings()
