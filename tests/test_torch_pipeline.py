"""The port's data pipeline (``repro_torch.data.pipeline``) against the
reference's ``repro.data.pipeline``: host batches bit-equal for every
``(seed, step, host_index)``, host sharding, and the prefetcher's order,
device placement and ``close``."""

import numpy as np
import pytest
import torch

from repro.data import pipeline as rpipe
from repro_torch.data import pipeline as pipe


@pytest.mark.parametrize("seed,step,hosts,vocab", [
    (0, 0, 1, 977), (3, 5, 1, 977), (1, 17, 2, 256), (7, 2, 4, 50280), (11, 123, 2, 256000),
])
def test_batch_bit_equal_to_reference(seed, step, hosts, vocab):
    cfg = dict(vocab_size=vocab, seq_len=48, global_batch=8, seed=seed)
    for host in range(hosts):
        got = pipe.SyntheticLM(pipe.DataConfig(**cfg), host, hosts).batch(step)
        want = rpipe.SyntheticLM(rpipe.DataConfig(**cfg), host, hosts).batch(step)
        assert got.keys() == want.keys()
        for k in got:
            assert got[k].dtype == want[k].dtype == np.int32
            np.testing.assert_array_equal(got[k], want[k])


def test_data_deterministic_replay_and_labels_are_shifted_tokens():
    cfg = pipe.DataConfig(vocab_size=977, seq_len=64, global_batch=8, seed=3)
    a, b = pipe.SyntheticLM(cfg).batch(5), pipe.SyntheticLM(cfg).batch(5)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    assert not np.array_equal(a["tokens"], pipe.SyntheticLM(cfg).batch(6)["tokens"])
    np.testing.assert_array_equal(a["tokens"][:, 1:], a["labels"][:, :-1])
    assert a["tokens"].min() >= 0 and a["tokens"].max() < 977


def test_host_sharding_partitions_the_batch():
    cfg = pipe.DataConfig(vocab_size=977, seq_len=32, global_batch=8, seed=1)
    h0 = pipe.SyntheticLM(cfg, host_index=0, num_hosts=2).batch(0)
    h1 = pipe.SyntheticLM(cfg, host_index=1, num_hosts=2).batch(0)
    assert h0["tokens"].shape == h1["tokens"].shape == (4, 32)
    assert not np.array_equal(h0["tokens"], h1["tokens"])
    with pytest.raises(ValueError, match="split"):
        pipe.SyntheticLM(cfg, num_hosts=3)


def test_prefetcher_order_device_and_close():
    cfg = pipe.DataConfig(vocab_size=100, seq_len=16, global_batch=4)
    src = pipe.SyntheticLM(cfg)
    pf = pipe.Prefetcher(src, start_step=3, depth=2,
                         put_fn=lambda b: pipe.to_device(b, torch.device("cpu")))
    try:
        for want in (3, 4, 5, 6):
            step, batch = pf.next()
            assert step == want
            assert isinstance(batch["tokens"], torch.Tensor)
            assert batch["tokens"].dtype == torch.int32
            np.testing.assert_array_equal(batch["tokens"].numpy(), src.batch(want)["tokens"])
    finally:
        pf.close()
    assert not pf._thread.is_alive()


def test_prefetcher_close_with_a_full_queue_joins_the_thread():
    pf = pipe.Prefetcher(pipe.SyntheticLM(pipe.DataConfig(vocab_size=50, seq_len=8,
                                                          global_batch=2)), depth=1)
    step, _ = pf.next()
    assert step == 0
    pf.close()
    assert not pf._thread.is_alive()
