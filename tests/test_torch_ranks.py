"""Ranks on one host (``launch.ranks``) and the mesh over them
(``launch.mesh``), on the CPU over gloo.

(a) ``make_mesh`` inside 4, 3 and 2 spawned ranks is a ``DeviceMesh`` of
    the world, pod-major, and ``rank_axes`` gives each rank its
    coordinates and the process group of each axis.
(b) The messages: ``exchange`` swaps with a peer, ``all_reduce``,
    ``broadcast`` and ``all_gather`` over an axis's group, the bytes a
    rank sends counted by its ``Staging``; every rank of a group ends with
    the same bits.
(c) The backend is named by the caller and checked before any rank
    starts: ``nccl`` refuses more ranks than visible cards.
(d) A rank that raises before its send fails the run with its traceback,
    and its waiting peer fails too instead of hanging; a rank that stays
    silent fails its peer at the group's timeout.
"""
import time

import pytest
import torch

from repro_torch.launch import ranks as RK


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def mesh_and_messages(ctx, shape, axes):
    """A rank body: the mesh's coordinates and groups, then one message of
    each kind along each axis."""
    from repro_torch.launch.mesh import make_mesh, rank_axes
    mesh = make_mesh(shape, axes, device="cpu")
    ax = rank_axes(mesh)
    st = RK.Staging()
    out = {"coords": ax.coords, "sizes": ax.sizes,
           "groups": {a: RK.group_ranks(ax.group(a)) for a in axes},
           "type": type(mesh).__name__}
    mine = torch.arange(5, dtype=torch.float32) + 10 * ctx.rank
    for a in axes:
        g = ax.group(a)
        ranks = RK.group_ranks(g)
        out[a, "sum"] = RK.all_reduce(st, mine.clone() / 3, g)
        out[a, "bcast"] = RK.broadcast(st, mine.clone(), ranks[-1], g)
        out[a, "gather"] = RK.all_gather(st, mine, g)
        if len(ranks) == 2:
            out[a, "swap"] = RK.exchange(st, [mine, mine.int()],
                                         RK.peer_of(g), g)
    out["sent"] = st.sent
    return out


@pytest.mark.parametrize("shape,axes", [((2, 2), ("pod", "data")),
                                        ((3,), ("pod",)),
                                        ((2, 1), ("pod", "data"))])
def test_mesh_axes_and_messages_over_ranks(shape, axes):
    n = 1
    for k in shape:
        n *= k
    outs = RK.spawn(mesh_and_messages, n, backend="gloo", device="cpu",
                    args=(shape, axes))
    for rank, o in enumerate(outs):
        assert o["type"] == "DeviceMesh"
        assert o["sizes"] == dict(zip(axes, shape))
        # pod-major: rank = pod * data + d
        idx = 0
        for a in axes:
            idx = idx * o["sizes"][a] + o["coords"][a]
        assert idx == rank
        swaps = 0
        for a in axes:
            ranks = o["groups"][a]
            assert rank in ranks and len(ranks) == o["sizes"][a]
            vals = [torch.arange(5, dtype=torch.float32) + 10 * r
                    for r in ranks]
            assert torch.equal(o[a, "gather"], torch.stack(vals))
            assert torch.equal(o[a, "bcast"], vals[-1])
            for r in ranks:                      # one bit pattern a group
                assert torch.equal(outs[r][a, "sum"], o[a, "sum"])
            torch.testing.assert_close(o[a, "sum"], sum(vals) / 3)
            if len(ranks) == 2:
                peer = ranks[1 - ranks.index(rank)]
                assert torch.equal(o[a, "swap"][0], vals[ranks.index(peer)])
                assert o[a, "swap"][1].dtype == torch.int32
                swaps += 1
        assert o["sent"] == swaps * 5 * (4 + 4)


def test_nccl_refuses_more_ranks_than_cards(monkeypatch):
    with pytest.raises(ValueError, match="name one of"):
        RK.check_backend("mpi", 2, "cpu")
    with pytest.raises(ValueError, match="runs on cards"):
        RK.check_backend("nccl", 2, "cpu")
    # a host with one card: nccl takes one rank, refuses two; gloo stages
    # any number of ranks on it through the host
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert RK.check_backend("nccl", 1, "cuda").type == "cuda"
    assert RK.check_backend("gloo", 4, "cuda").type == "cuda"
    with pytest.raises(ValueError, match="4 ranks but 1 visible card"):
        RK.check_backend("nccl", 4, "cuda")
    with pytest.raises(ValueError, match="4 ranks but 1 visible card"):
        RK.spawn(mesh_and_messages, 4, backend="nccl", device="cuda",
                 args=((4,), ("pod",)))


def dies_before_its_send(ctx):
    """A rank body: rank 0 raises before it sends; rank 1 waits for it."""
    if ctx.rank == 0:
        raise ValueError("rank 0 stops before its send")
    return RK.recv(RK.Staging(), [torch.zeros(4)], 0).wait()


def stays_silent(ctx):
    """A rank body: rank 0 sends nothing and outlives rank 1's timeout."""
    if ctx.rank == 0:
        time.sleep(6)
        return None
    return RK.recv(RK.Staging(), [torch.zeros(4)], 0).wait()


def test_a_peer_waiting_on_a_failed_or_silent_rank_fails():
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError) as e:
        RK.spawn(dies_before_its_send, 2, backend="gloo", device="cpu")
    assert "rank 0 stops before its send" in str(e.value)
    assert "--- rank 1 ---" in str(e.value)
    with pytest.raises(RuntimeError) as e:
        RK.spawn(stays_silent, 2, backend="gloo", device="cpu", timeout_s=2)
    assert "--- rank 1 ---" in str(e.value)
    assert time.perf_counter() - t0 < 60
