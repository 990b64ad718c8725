"""The traffic generators repeat for a seed, keep to their ranges, and the
training rows are the port's loader's, bit for bit."""

import numpy as np

import pb_cases  # noqa: F401  (the import path)

from portbench import harness, traffic

BIG = 2**31 + 12345  # a seed may pass 32 signed bits


def test_decode_plan_repeats_and_every_seed_serves_the_same_shapes():
    tr = harness.data("workloads", pb_cases.DECODE)["traffic"]
    listed = sorted(tuple(x) for x in tr["batches"])
    k = len(listed)
    a, b = (traffic.decode_plan(tr, 65024, BIG) for _ in range(2))
    c = traffic.decode_plan(tr, 65024, BIG + 1)
    shapes = [a.shape(i) for i in range(8 * k)]
    assert shapes == [b.shape(i) for i in range(8 * k)]
    others = [c.shape(i) for i in range(8 * k)]
    assert shapes != others
    for plan in (shapes, others):  # each pass serves the list once
        for j in range(0, 8 * k, k):
            assert sorted(plan[j:j + k]) == listed
    assert all(p > n for p, n in listed)  # prompts longer than answers
    pa, pb = a.prompts(3, "cpu"), b.prompts(3, "cpu")
    assert pa.shape == (tr["batch"], shapes[3][0]) and bool((pa == pb).all())
    assert int(pa.min()) >= 3 and int(pa.max()) < 65024


def test_train_rows_repeat_and_equal_the_loader():
    from repro_torch.data.pipeline import DataConfig, ShardedLoader

    tr = dict(harness.data("workloads", pb_cases.TRAIN)["traffic"],
              seq_len=256)
    loader = ShardedLoader(DataConfig(vocab=73448, seq_len=256,
                                      global_batch=2, seed=BIG,
                                      mean_doc_len=512))
    for step in range(3):
        want = next(loader)
        got = traffic.train_rows(tr, 73448, BIG, step)
        again = traffic.train_rows(tr, 73448, BIG, step)
        for k in ("tokens", "targets"):
            assert np.array_equal(got[k], want[k])
            assert np.array_equal(got[k], again[k])
    assert not np.array_equal(traffic.train_rows(tr, 73448, BIG, 0)["tokens"],
                              traffic.train_rows(tr, 73448, BIG, 1)["tokens"])
