"""The shard layout (kmerind_tpu_torch.parallel.mesh) and the one-process
behaviour of the multi-process surface: without a process group every
layout has one rank, every collective is the identity, and an index given
a mesh holds exactly what the same index given `nparts` holds."""

import pytest
import torch

import kmerind_tpu_torch as kp
from kmerind_tpu_torch.parallel import distribute as dist
from kmerind_tpu_torch.parallel.mesh import Mesh, as_mesh, make_mesh, \
    make_mesh_2d
from kmerind_tpu_torch.parallel.multihost import initialize
from kmerind_tpu_torch.utils.timers import (MemUsage, PhaseTimer,
                                            device_memory_stats)

from torch_parity import write_reads


def test_layouts_without_a_group():
    m = make_mesh(4, "cpu")
    assert (m.world, m.rank, m.p_local, m.shard_range, m.shape) == \
        (1, 0, 4, (0, 4), (4,))
    assert make_mesh(device="cpu").nparts == 1
    assert make_mesh_2d(nparts=4, device="cpu").shape == (1, 4)
    with pytest.raises(ValueError, match="hosts"):
        make_mesh_2d(2, nparts=4, device="cpu")
    with pytest.raises(ValueError, match="split"):
        Mesh(3, world=2)
    assert as_mesh(m) is m and as_mesh(3).nparts == 3


def test_one_rank_collectives_are_identities():
    m = make_mesh(2, "cpu")
    t = torch.arange(6).reshape(3, 2)
    assert m.all_max(5) == m.all_sum(5) == 5
    for f in (m.all_gather, m.all_gather_ragged, m.all_to_all,
              m.all_sum_tensor):
        assert f(t) is t
    m.barrier()


def test_initialize_is_a_noop_without_a_launcher(monkeypatch):
    for v in ("WORLD_SIZE", "RANK", "MASTER_ADDR"):
        monkeypatch.delenv(v, raising=False)
    assert initialize() is False
    assert not torch.distributed.is_initialized()


def test_exchange_takes_a_one_rank_mesh():
    """`distribute` / `undistribute` given a one-rank Mesh route exactly as
    given its shard count."""
    g = torch.Generator().manual_seed(5)
    p, n, cap = 3, 40, 32
    x = torch.randint(0, 1000, (p, n), generator=g)
    owner = torch.randint(0, p, (p, n), generator=g)
    valid = torch.rand((p, n), generator=g) < 0.8
    a = dist.distribute((x,), owner, valid, p, cap)
    b = dist.distribute((x,), owner, valid, make_mesh(p, "cpu"), cap)
    for u, v in zip((*a[0], a[1]), (*b[0], b[1])):
        assert torch.equal(u, v)
    back = dist.undistribute(b[0], b[2], make_mesh(p, "cpu"), cap, fill=-1)
    assert torch.equal(back[0], torch.where(valid, x, -1))


@pytest.fixture(scope="module")
def reads(tmp_path_factory):
    path = tmp_path_factory.mktemp("mesh") / "reads.fastq"
    write_reads(path, 120, 100, 2500, seed=2, fmt="fastq", n_rate=0.01)
    return path


@pytest.mark.parametrize("make", [
    lambda **kw: kp.CountIndex(kp.KmerSpec(21, kp.DNA), **kw),
    lambda **kw: kp.SortedCountIndex(kp.KmerSpec(21, kp.DNA), **kw),
    lambda **kw: kp.PositionIndex(kp.KmerSpec(21, kp.DNA), **kw),
    lambda **kw: kp.KmerValueIndex(kp.KmerSpec(21, kp.DNA), **kw),
    lambda **kw: kp.DeBruijnGraph(kp.KmerSpec(21, kp.DNA), **kw),
    lambda **kw: kp.BimoleculeCountIndex(kp.KmerSpec(21, kp.DNA), **kw)],
    ids=["count", "sorted", "position", "value", "debruijn", "bimolecule"])
def test_an_index_on_a_one_rank_mesh_equals_nparts(reads, make):
    a = make(device="cpu", nparts=3).build(reads)
    b = make(mesh=make_mesh(3, "cpu")).build(reads)
    assert b.nparts == 3 and b.device == torch.device("cpu")
    assert a.to_dict() == b.to_dict() and a.size() == b.size()
    assert list(a.local_sizes()) == list(b.local_sizes())
    with pytest.raises(ValueError, match="disagrees"):
        make(nparts=2, mesh=make_mesh(3, "cpu"))


def test_timers_on_one_process():
    t = PhaseTimer()
    with t.phase("insert"):
        pass
    t.add("insert", 1.0)
    s = t.cross_host_stats()
    assert s["insert"]["count"] == 1 and s["insert"]["sum"] >= 1.0
    assert "[TIME] x\tinsert\t1\t" in t.report("x", cross_host=True)
    m = MemUsage()
    m.mark("a")
    cur, peak = m.marks["a"]
    assert 0 < cur <= peak
    assert "[MEM] t\ta\t" in m.report("t")
    stats = device_memory_stats()
    assert len(stats) == torch.cuda.device_count()
    assert all("allocated_bytes.all.peak" in v for v in stats.values())
