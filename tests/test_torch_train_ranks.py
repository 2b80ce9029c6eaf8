"""The train step and the launcher over a mesh of ranks (``launch.ranks``
over gloo on the CPU).

(a) The data-parallel step on (2, 2) pod x data ranks equals the one-rank
    step on the whole batch, with a ``label_mask`` that gives the ranks
    unequal counts of labels (so a mean of the ranks' means would not be
    the batch's mean): three steps of reduced llama3.2-1b in f32, each
    loss within rtol 1e-5; the params within 1e-5 of each leaf's largest
    |value| at all but 0.5% of the elements (AdamW's first steps move an
    element by about lr whatever its gradient's size, so a gradient at
    rounding level can point either way: measured, 0.1% of the embedding,
    1.1e-4 at most) and nowhere further apart than twice the one-rank
    run's largest move, the ranks' blocks (the reference's FSDP layout:
    every leaf with an ``embed`` dim split over data) put side by side;
    the two pods end with the same bits of each block.
(b) The launcher: ``--mesh 2x2 --multi-pod --compress-pod-grads --backend
    gloo`` runs, rank 0 alone writes checkpoints and a run resumes from
    them over ranks; a ``model`` axis (``--mesh 1x2``, ``--multi-pod
    --mesh 2x2x2``, plain and with ``--compress-pod-grads``) runs and
    rank 0 alone prints the summary line;
    ``--backend`` is required for a mesh of several devices; ``nccl``
    with more ranks than cards, ``--ckpt-dir`` with a model axis and
    ``--production-mesh`` are refused by name.
(c) A failing rank fails the run, with every failed rank's traceback.
"""
import os

import numpy as np
import pytest
import torch

from repro_torch.configs import ShapeConfig, get_arch, reduced
from repro_torch.data.tokens import SyntheticTokenStream
from repro_torch.launch import rank_jobs, train
from repro_torch.launch import ranks as RK
from repro_torch.launch.mesh import LogicalMesh
from repro_torch.models.api import build_model
from repro_torch.optim import adamw
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime import steps as S
from repro_torch.tree import map_tree, named_leaves

B, SEQ, STEPS = 8, 32, 3
OPT = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
LOSS_RTOL = 1e-5
PARAM_TOL, PARAM_SHARE = 1e-5, 5e-3
LAUNCH = ["--arch", "llama3.2-1b", "--reduced", "--device", "cpu",
          "--batch", "8", "--seq", "32", "--steps", "3"]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mask():
    """Rows 0-1 (rank 0's) lose 5 labels each, row 6 (rank 3's) 22."""
    mask = np.ones((B, SEQ), np.int32)
    mask[0:2, :5] = 0
    mask[6, 10:] = 0
    return mask


def test_data_parallel_step_equals_one_rank_on_the_whole_batch():
    cfg = reduced(get_arch("llama3.2-1b"))
    api = build_model(cfg, device="cpu", dtype=torch.float32)
    params = api.init(torch.Generator().manual_seed(0))
    p0 = named_leaves(map_tree(lambda t: t.clone(), params))
    job = rank_jobs.TrainJob(cfg, ((2, 2), ("pod", "data")), STEPS, B, SEQ,
                             opt=OPT, params=map_tree(lambda t: t.clone(),
                                                      params),
                             label_mask=_mask())
    outs = RK.spawn(rank_jobs.train, 4, backend="gloo", device="cpu",
                    args=(job,))
    step = S.make_train_step(api, OPT, ShapeConfig("t", SEQ, B, "train"),
                             device="cpu")
    opt = adamw.init(params)
    data = SyntheticTokenStream(cfg.vocab_size, B, SEQ)
    losses = []
    for i in range(STEPS):
        batch = dict(next(data), label_mask=_mask())
        loss, params, opt, _ = step(params, opt, batch, np.int32(i))
        losses.append(float(loss))
    np.testing.assert_allclose(outs[0]["losses"], losses, rtol=LOSS_RTOL)
    for r, o in enumerate(outs):
        assert o["losses"] == outs[0]["losses"]
        # pod 1's data rank d holds pod 0's data rank d's blocks
        assert o["digests"] == outs[r % 2]["digests"]
    got = named_leaves(S.join_blocks(api, LogicalMesh((2, 2), ("pod", "data")),
                                     [o["params"] for o in outs]))
    for name, w in named_leaves(params).items():
        d = (got[name] - w).abs()
        off = d > PARAM_TOL * w.abs().max()
        assert off.float().mean() <= PARAM_SHARE, (name, int(off.sum()))
        assert d.max() <= 2 * (w - p0[name]).abs().max(), name
    # ranks counted no bytes by point-to-point messages: the step reduces
    # with one all_reduce a step
    assert outs[0]["sent_per_step"] == 0


def test_launcher_runs_the_compressed_step_over_pods_and_data(capsys):
    result = train.main(LAUNCH + ["--mesh", "2x2", "--multi-pod",
                                  "--compress-pod-grads", "--backend",
                                  "gloo"])
    assert result["step"] == STEPS and len(result["losses"]) == STEPS
    assert all(np.isfinite(result["losses"]))


def test_launcher_checkpoints_from_rank_0_and_resumes_over_ranks(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    flags = ["--mesh", "2x1", "--backend", "gloo", "--f32", "--ckpt-dir",
             ckpt, "--ckpt-every", "2"]
    straight = train.main(LAUNCH + flags[:5])
    first = train.main(LAUNCH[:-1] + ["2"] + flags)
    assert sorted(os.listdir(ckpt)) == ["LATEST", "step_2"], os.listdir(ckpt)
    resumed = train.main(LAUNCH + flags)
    assert resumed["step"] == STEPS and len(resumed["losses"]) == 1
    assert first["losses"] + resumed["losses"] == straight["losses"]


def test_backend_is_named_and_checked_before_ranks_start():
    with pytest.raises(ValueError, match="--backend"):
        train.main(LAUNCH + ["--mesh", "2x1"])
    with pytest.raises(ValueError, match="nccl"):
        train.main(LAUNCH + ["--mesh", "2x1", "--backend", "nccl"])


@pytest.mark.parametrize("flags,names", [
    (["--production-mesh"], "--production-mesh"),
    (["--production-mesh", "--multi-pod"], "--production-mesh"),
    (["--mesh", "1x2", "--ckpt-dir", "unwritten"], "model axis"),
    (["--mesh", "2x2x2", "--multi-pod", "--ckpt-dir", "unwritten"],
     "model axis")])
def test_launcher_refuses_tensor_parallel_meshes_by_name(flags, names):
    # a model axis trains (below); checkpoints of its shards are step 7
    with pytest.raises(NotImplementedError, match=names) as e:
        train.main(LAUNCH + ["--backend", "gloo", *flags])
    assert "item 10d" in str(e.value)
    assert not os.path.exists("unwritten")


@pytest.mark.parametrize("flags,mesh", [
    (["--mesh", "1x2"], "{'data': 1, 'model': 2}"),
    (["--mesh", "2x2x2", "--multi-pod"],
     "{'pod': 2, 'data': 2, 'model': 2}"),
    (["--mesh", "2x2x2", "--multi-pod", "--compress-pod-grads"],
     "{'pod': 2, 'data': 2, 'model': 2}")])
def test_launcher_runs_tensor_parallel_meshes(capfd, flags, mesh):
    result = train.main(LAUNCH + ["--backend", "gloo", *flags])
    assert result["step"] == STEPS and len(result["losses"]) == STEPS
    assert all(np.isfinite(result["losses"]))
    lines = [l for l in capfd.readouterr().out.splitlines()
             if l.startswith("arch=")]
    # rank 0 alone prints the summary
    assert len(lines) == 1, lines
    assert lines[0].startswith("arch=llama3.2-1b-reduced device=cpu ")
    kind = " compressed" if "--compress-pod-grads" in flags else ""
    assert f"mesh={mesh} backend=gloo{kind} steps=3 loss " in lines[0]


def test_a_failing_rank_fails_the_run():
    # both ranks refuse a batch of 3 rows over 2 ranks
    with pytest.raises(RuntimeError, match="does not split") as e:
        train.main(LAUNCH[:5] + ["--batch", "3", "--seq", "32", "--steps",
                                 "1", "--mesh", "2x1", "--backend", "gloo"])
    assert "rank 0" in str(e.value) and "rank 1" in str(e.value)
