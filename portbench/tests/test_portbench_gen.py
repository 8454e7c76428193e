"""The traffic generator: copies of the port's seeded makers, sizes that
the seed does not change."""

import numpy as np

from portbench import gen


def test_makers_equal_the_ports_own():
    from zultra_tpu_torch import corpus

    for size, seed in ((1000, 1), (100_000, 2), (777_777, 2**33 + 5)):
        assert gen.mixed(size, np.random.default_rng(seed)) == corpus.mixed_corpus(size, seed)
    for size in (10, 1024, 50_000):
        assert gen.text(np.random.default_rng(4), size) == corpus._text(np.random.default_rng(4), size)


def test_files_have_the_sources_size_and_the_seed_draws_content_and_order():
    p = gen.load("files48k")
    a_in, a_order = gen.make(p, 3)
    b_in, b_order = gen.make(p, 2**31 + 99)
    assert [len(x) for x in a_in] == [len(x) for x in b_in] == [48_944] * 64
    assert sorted(a_order) == list(range(64)) and a_order != b_order
    assert len(set(a_in)) == 64 and a_in[0] != b_in[0]
    assert gen.make(p, 3) == (a_in, a_order)


def test_one_buffer_is_one_fixed_corpus_whose_pieces_the_seed_shuffles_within_groups():
    from zultra_tpu_torch import corpus

    p = gen.load("mixed100m")
    assert p["size"] == 100_000_000 and p.get("inputs", 1) == 1
    assert (p["piece"], p["group"]) == (1 << 20, 16)
    fixed = {k: v for k, v in p.items() if k not in ("piece", "group")}
    small = dict(fixed, size=100_000)
    assert gen.make(small, 11) == gen.make(small, 2**32 + 11) == (
        [corpus.mixed_corpus(100_000, p["content_seed"])], [0])
    small = dict(p, size=10 * 4096 + 777, piece=4096, group=4)
    (base,), _ = gen.make({k: v for k, v in small.items() if k not in ("piece", "group")}, 0)
    pieces = [base[i * 4096:(i + 1) * 4096] for i in range(10)]
    seen = set()
    for seed in (11, 2**32 + 11, 12):
        (x,), order = gen.make(small, seed)
        assert order == [0] and len(x) == len(base) and x[-777:] == base[-777:]
        got = [x[i * 4096:(i + 1) * 4096] for i in range(10)]
        for lo in (0, 4, 8):  # the same pieces in each group, in another order
            assert sorted(got[lo:lo + 4]) == sorted(pieces[lo:lo + 4])
        seen.add(x)
    assert len(seen) == 3 and gen.make(small, 12) == gen.make(small, 12)
