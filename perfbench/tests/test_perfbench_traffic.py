"""The traffic generator: the same seed gives the same stream, every seed
the same multiset of sizes and gaps, and the mixes' shapes hold."""

import collections

import numpy as np
import pytest

import perfbench_smoke as S
from perfbench.harness.spec import load_json
from perfbench.harness.traffic import Stream, quantile, zipf_counts

MIXES = sorted(p.stem for p in (S.ROOT / "perfbench" / "traffic").glob(
    "*.json"))
SEEDS = [0, 7, 2**31 + 12345, 9_876_543_210]


def _mix(name):
    return load_json(S.ROOT / "perfbench" / "traffic" / f"{name}.json")


def _sizes(stream, n):
    """Sorted prompt (or question) lengths, answers, gaps, documents."""
    items = [stream.item(i) for i in range(n)]
    doc = [0 if it.doc < 0 else int(stream.doc_lens[it.doc]) for it in items]
    return (sorted(len(it.prompt) - d for it, d in zip(items, doc)),
            sorted(it.max_new_tokens for it in items),
            sorted(round(it.gap_s, 12) for it in items),
            sorted(it.doc for it in items))


@pytest.mark.parametrize("mix", MIXES)
@pytest.mark.parametrize("seed", SEEDS)
def test_same_seed_same_stream(mix, seed):
    a = Stream(_mix(mix), seed, 1000, 16)
    b = Stream(_mix(mix), seed, 1000, 16)
    for i in (0, 1, 255, 256, 300):
        x, y = a.item(i), b.item(i)
        assert np.array_equal(x.prompt, y.prompt)
        assert (x.max_new_tokens, x.gap_s, x.doc) == (y.max_new_tokens,
                                                       y.gap_s, y.doc)


@pytest.mark.parametrize("mix", MIXES)
def test_every_seed_the_same_sizes_in_another_order(mix):
    m = _mix(mix)
    n = int(m.get("block", 256))
    sizes = [_sizes(Stream(m, s, 1000, 16), n) for s in SEEDS]
    assert all(s == sizes[0] for s in sizes[1:])
    firsts = [[Stream(m, s, 1000, 16).item(i).max_new_tokens
               for i in range(16)] for s in SEEDS]
    assert any(f != firsts[0] for f in firsts[1:])


@pytest.mark.parametrize("mix", MIXES)
def test_lengths_within_the_mix(mix):
    m = _mix(mix)
    st = Stream(m, 3, 1000, 16)
    items = [st.item(i) for i in range(600)]
    ans = m["answer_tokens"]
    assert all(ans["min"] <= it.max_new_tokens <= ans["max"] for it in items)
    assert all(0 <= int(it.prompt.min()) and int(it.prompt.max()) < 1000
               for it in items)
    assert max(len(it.prompt) for it in items) <= st.max_prompt_tokens
    if "prompt_tokens" in m:
        p = m["prompt_tokens"]
        assert all(p["min"] <= len(it.prompt) <= p["max"] for it in items)
        assert all(it.doc == -1 for it in items)
    else:
        counts = collections.Counter(it.doc for it in items[:256])
        assert counts.most_common(1)[0][1] > 256 / m["documents"]["count"]
        for it in items[:64]:
            doc = st.doc_tokens(it.doc)
            assert len(doc) % 16 == 0
            assert np.array_equal(it.prompt[:len(doc)], doc)
            q = m["question_tokens"]
            assert q["min"] <= len(it.prompt) - len(doc) <= q["max"]
        assert st.retain_pages > 0
    if m["loop"] == "open":
        gaps = [st.item(i).gap_s for i in range(256)]
        assert np.mean(gaps) == pytest.approx(1.0 / m["rate_per_s"],
                                              rel=0.02)
    else:
        assert m["clients"] >= 1


def test_quantiles_and_zipf():
    u = (np.arange(1000) + 0.5) / 1000
    lu = quantile({"dist": "loguniform", "min": 1024, "max": 8192}, u)
    assert 1024 <= lu.min() < 1030 and 8180 < lu.max() <= 8192
    assert np.median(lu) == pytest.approx(np.sqrt(1024 * 8192), rel=0.01)
    un = quantile({"dist": "uniform", "min": 16, "max": 64}, u)
    assert sorted(set(un.tolist())) == list(range(16, 65))
    z = zipf_counts(32, 1.0, 256)
    assert z.sum() == 256 and list(z) == sorted(z, reverse=True)
    assert z[0] == pytest.approx(256 / sum(1 / r for r in range(1, 33)),
                                 abs=1)


def test_open_loop_gaps():
    """An open-loop mix's arrival gaps: exponential quantiles at the
    mix's rate, the same multiset for every seed."""
    st = [Stream(S.SMOKE_OPEN, s, 256, 16) for s in SEEDS]
    n = S.SMOKE_OPEN["block"]
    gaps = [sorted(x.item(i).gap_s for i in range(n)) for x in st]
    assert all(g == gaps[0] for g in gaps)
    assert np.mean(gaps[0]) == pytest.approx(1 / S.SMOKE_OPEN["rate_per_s"],
                                             rel=0.1)
