"""The port's data pipelines against the reference's: the same batches,
bit for bit, from the same seed or file, and the same ``state()`` /
``restore()`` (``tests/test_training.py``'s data test, on the port)."""

import numpy as np
import pytest

from repro.data import FileTokenData as JFileTokenData
from repro.data import SyntheticLMData as JSyntheticLMData
from repro_torch.data import FileTokenData, SyntheticLMData, make_pipeline
from torch_threads import one_intra_op_thread  # noqa: F401  (an autouse fixture)


def _same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
        np.testing.assert_array_equal(a[k], b[k])


def test_data_determinism_and_restore():
    d1 = SyntheticLMData(100, 16, 2, seed=7)
    d2 = SyntheticLMData(100, 16, 2, seed=7)
    b1 = [d1.next_batch() for _ in range(3)]
    _ = [d2.next_batch() for _ in range(2)]
    st = d2.state()
    d3 = SyntheticLMData(100, 16, 2, seed=7)
    d3.restore(st)
    np.testing.assert_array_equal(b1[2]["tokens"], d3.next_batch()["tokens"])


@pytest.mark.parametrize("vocab,seq,batch,seed", [
    (512, 64, 4, 3),              # tests/test_training.py's reduced stablelm
    (151936, 1024, 4, 0),         # qwen3-1.7b's vocabulary, the card's training run
    (100, 16, 2, 7),
])
def test_synthetic_batches_are_the_references(vocab, seq, batch, seed):
    port, ref = SyntheticLMData(vocab, seq, batch, seed=seed), JSyntheticLMData(
        vocab, seq, batch, seed=seed)
    for _ in range(3):
        _same(port.next_batch(), ref.next_batch())
    assert port.state() == ref.state()
    port2, ref2 = SyntheticLMData(vocab, seq, batch, seed=seed), JSyntheticLMData(
        vocab, seq, batch, seed=seed)
    port2.restore(ref.state())
    ref2.restore(port.state())
    _same(port2.next_batch(), ref2.next_batch())


def test_file_batches_are_the_references(tmp_path):
    """A token file read in order, wrapped at its end, by two hosts."""
    path = tmp_path / "tokens.bin"
    np.random.default_rng(0).integers(0, 60000, 5000).astype(np.uint16).tofile(path)
    for host in (0, 1):
        port = make_pipeline("file", path=path, vocab_size=1000, seq_len=32, batch_size=3,
                             host_id=host, n_hosts=2)
        ref = JFileTokenData(path, 1000, 32, 3, host_id=host, n_hosts=2)
        assert isinstance(port, FileTokenData)
        for _ in range(40):        # past the end of the file: the epoch wraps
            _same(port.next_batch(), ref.next_batch())
        assert port.state() == ref.state()


def test_make_pipeline_refuses_unknown_kinds():
    assert isinstance(make_pipeline("synthetic", vocab_size=10, seq_len=4, batch_size=1),
                      SyntheticLMData)
    with pytest.raises(ValueError, match="unknown pipeline kind"):
        make_pipeline("stream")
