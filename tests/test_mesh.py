"""Multi-host plumbing: init_distributed resolution + make_host_mesh
grouping.

jax.distributed.initialize is monkeypatched -- the semantics under test
are the argument/env resolution and device grouping, not JAX's own
process bootstrap (which needs real multi-process infra)."""

import numpy as np
import pytest

import jax

from zklaim_tpu.parallel import mesh as MESH


@pytest.fixture(autouse=True)
def _reset_dist_state():
    MESH._DIST_STATE["initialized"] = False
    yield
    MESH._DIST_STATE["initialized"] = False


def test_init_distributed_noop_without_config(monkeypatch):
    for var in ("ZKLAIM_COORDINATOR", "ZKLAIM_NUM_PROCESSES",
                "ZKLAIM_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    called = []
    monkeypatch.setattr(
        jax.distributed, "initialize", lambda **kw: called.append(kw)
    )
    assert MESH.init_distributed() is False
    assert called == []


def test_init_distributed_explicit_args(monkeypatch):
    called = []
    monkeypatch.setattr(
        jax.distributed, "initialize", lambda **kw: called.append(kw)
    )
    assert MESH.init_distributed("10.0.0.1:1234", 4, 2) is True
    assert called == [
        {
            "coordinator_address": "10.0.0.1:1234",
            "num_processes": 4,
            "process_id": 2,
        }
    ]
    # idempotent: second call does not re-initialize
    assert MESH.init_distributed() is True
    assert len(called) == 1


def test_init_distributed_env_resolution(monkeypatch):
    monkeypatch.setenv("ZKLAIM_COORDINATOR", "coord:9999")
    monkeypatch.setenv("ZKLAIM_NUM_PROCESSES", "8")
    monkeypatch.setenv("ZKLAIM_PROCESS_ID", "3")
    called = []
    monkeypatch.setattr(
        jax.distributed, "initialize", lambda **kw: called.append(kw)
    )
    assert MESH.init_distributed() is True
    assert called == [
        {
            "coordinator_address": "coord:9999",
            "num_processes": 8,
            "process_id": 3,
        }
    ]


def test_init_distributed_pod_autodetect(monkeypatch):
    """There is no autodetection: cluster variables of any platform do
    not start a process group; only explicit configuration does."""
    for var in ("ZKLAIM_COORDINATOR", "ZKLAIM_NUM_PROCESSES",
                "ZKLAIM_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("SLURM_NTASKS", "2")
    called = []
    monkeypatch.setattr(
        jax.distributed, "initialize", lambda **kw: called.append(kw)
    )
    assert MESH.init_distributed() is False
    assert called == []


class _FakeDev:
    def __init__(self, pid, did):
        self.process_index = pid
        self.id = did

    def __repr__(self):
        return f"dev(p{self.process_index},d{self.id})"


def test_make_host_mesh_groups_by_process(monkeypatch):
    devs = [_FakeDev(p, p * 4 + d) for p in range(2) for d in range(4)]
    monkeypatch.setattr(jax, "devices", lambda: devs)
    m = MESH.make_host_mesh()
    assert m.axis_names == ("host", "chip")
    assert m.devices.shape == (2, 4)
    # trailing axis is intra-host: every row holds one process's chips
    for row in m.devices:
        assert len({d.process_index for d in row}) == 1


def test_make_host_mesh_rejects_uneven(monkeypatch):
    devs = [_FakeDev(0, 0), _FakeDev(0, 1), _FakeDev(1, 2)]
    monkeypatch.setattr(jax, "devices", lambda: devs)
    with pytest.raises(ValueError):
        MESH.make_host_mesh()


def test_make_host_mesh_single_process_degenerates():
    m = MESH.make_host_mesh()
    assert m.devices.shape[0] == 1
    assert m.devices.shape[1] == len(jax.devices())


def test_flat_shard_axis():
    m = MESH.make_mesh(2)
    assert MESH.flat_shard_axis(m) == ("shards",)
    hm = MESH.make_host_mesh()
    assert MESH.flat_shard_axis(hm) == ("host", "chip")
