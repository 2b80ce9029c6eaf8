"""The port's data pipelines (``repro_torch.data``) against the JAX
package's: the reference's tests of determinism and the checkpointable
cursor (tests/test_data.py) run on the port's copies, and every batch,
shard and frame equals the reference's array for array (exact: both are
the same numpy code on the same seeds)."""
import numpy as np
import pytest

from repro.data.stream import VideoChunkStream as JaxVideo
from repro.data.tokens import HostShardedStream as JaxSharded
from repro.data.tokens import SyntheticTokenStream as JaxTokens
from repro_torch.data import (HostShardedStream, SyntheticTokenStream,
                              VideoChunkStream)


def test_deterministic_per_step():
    a = SyntheticTokenStream(512, 4, 16, seed=3)
    b = SyntheticTokenStream(512, 4, 16, seed=3)
    for _ in range(3):
        x, y = next(a), next(b)
        np.testing.assert_array_equal(x["tokens"], y["tokens"])
        np.testing.assert_array_equal(x["labels"], y["labels"])


def test_resume_reproduces_order():
    a = SyntheticTokenStream(512, 2, 8, seed=1)
    seen = [next(a)["tokens"] for _ in range(5)]
    b = SyntheticTokenStream(512, 2, 8, seed=1)
    b.load_state_dict({"step": 3, "seed": 1})
    np.testing.assert_array_equal(next(b)["tokens"], seen[3])


def test_labels_learnable_structure():
    s = SyntheticTokenStream(97, 8, 64, seed=0, structure=1.0)
    b = next(s)
    np.testing.assert_array_equal(b["labels"], (b["tokens"] * 31 + 7) % 97)


def test_host_sharding_partitions_batch():
    base = SyntheticTokenStream(512, 8, 4, seed=0)
    h0 = HostShardedStream(SyntheticTokenStream(512, 8, 4, seed=0), 0, 2)
    h1 = HostShardedStream(SyntheticTokenStream(512, 8, 4, seed=0), 1, 2)
    full = next(base)["tokens"]
    np.testing.assert_array_equal(next(h0)["tokens"], full[:4])
    np.testing.assert_array_equal(next(h1)["tokens"], full[4:])


def test_video_chunks():
    v = VideoChunkStream(resolution=32, chunk_size=3, seed=5)
    c0 = next(v)
    assert len(c0) == 3 and c0[0].shape == (32, 32, 3)
    v2 = VideoChunkStream(resolution=32, chunk_size=3, seed=5)
    np.testing.assert_array_equal(c0[0], next(v2)[0])
    assert not np.array_equal(c0[0], c0[1])


@pytest.mark.parametrize("vocab,batch,seq,seed,structure", [
    (512, 4, 16, 3, 0.9), (128256, 8, 128, 0, 0.9), (97, 8, 64, 0, 1.0),
    (151936, 2, 33, 7, 0.5)])
def test_token_batches_equal_the_reference(vocab, batch, seq, seed,
                                           structure):
    port = SyntheticTokenStream(vocab, batch, seq, seed=seed,
                                structure=structure)
    ref = JaxTokens(vocab, batch, seq, seed=seed, structure=structure)
    for _ in range(3):
        a, b = next(port), next(ref)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    assert port.state_dict() == ref.state_dict()
    port.load_state_dict({"step": 11, "seed": seed})
    ref.load_state_dict({"step": 11, "seed": seed})
    np.testing.assert_array_equal(next(port)["labels"], next(ref)["labels"])


def test_shards_and_frames_equal_the_reference():
    for i in range(2):
        a = HostShardedStream(SyntheticTokenStream(512, 8, 4, seed=2), i, 2)
        b = JaxSharded(JaxTokens(512, 8, 4, seed=2), i, 2)
        np.testing.assert_array_equal(next(a)["tokens"], next(b)["tokens"])
        assert a.state_dict() == b.state_dict()
    a = VideoChunkStream(resolution=24, chunk_size=2, seed=4)
    b = JaxVideo(resolution=24, chunk_size=2, seed=4)
    for x, y in zip(next(a), next(b)):
        np.testing.assert_array_equal(x, y)
    assert a.state_dict() == b.state_dict()
