"""The port's write-ahead journal on the CPU against the JAX package's.

Every framing scenario (lifecycle, rotation, torn tails, CRC damage,
reopen repair, unknown records, crashes, the two WAL fault sites, the
replay state machine) runs once through each package's writer: the
segment files must be byte-identical, and each directory must replay to
the same state through either package's reader.  Then whole engines:
a journal written by the JAX engine finishes in the port and the
reverse, bf16 swap images cross both ways with equal bytes and
checksums, and crash-restart (single engine, truncated tail, a crash
during recovery, a cluster) gives the JAX oracle's greedy tokens.

Tolerances: replay states equal field for field, image bytes and CRCs
equal, greedy tokens equal exactly (fp32 smoke engines on one parameter
set, the JAX init converted).
"""

import dataclasses
import json
import os
import struct
import zlib

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import repro.serving as jsv
import repro.serving.journal as jj
import repro_torch.serving as tsv
import repro_torch.serving.journal as tj
from repro.configs.registry import get_config as jax_config
from repro.models.api import build_model as jax_build
from repro.quant.policy import PrecisionPolicy as JaxPolicy
from repro.serving.faults import image_checksum as jax_checksum
from repro_torch.configs.registry import get_config
from repro_torch.convert import params_from_jax
from repro_torch.models.api import build_model
from repro_torch.quant.policy import PrecisionPolicy
from repro_torch.serving.faults import image_checksum

PKGS = {"jax": (jsv, jj), "torch": (tsv, tj)}


def _files(d):
    out = {}
    for root, _, names in os.walk(d):
        for n in names:
            p = os.path.join(root, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, d)] = f.read()
    return out


def _seg(d):
    return os.path.join(d, sorted(f for f in os.listdir(d)
                                  if f.startswith("wal-"))[-1])


def _req(sv, rid, prompt_len=4, gen=5, tokens=()):
    r = sv.Request(rid=rid, prompt=np.arange(prompt_len, dtype=np.int32),
                   max_new_tokens=gen)
    r.tokens = list(tokens)
    return r


# ------------------------------------------------------------ scenarios
# Each writes one journal directory through package ``sv`` / ``j``.
def sc_lifecycle(sv, j, d):
    w = j.JournalWriter(d)
    req = _req(sv, 1)
    w.submit(req)
    req.tokens = [7, 8]
    w.admit(req, restore=False)
    w.checkpoint(1, [req])
    req.tokens = [7, 8, 9, 10, 11]
    w.complete(req)
    w.close()


def sc_rotation(sv, j, d):
    w = j.JournalWriter(d, segment_bytes=256)
    for i in range(30):
        w.submit(_req(sv, i, prompt_len=8))
    w.close()


def sc_torn_tail(sv, j, d):
    w = j.JournalWriter(d)
    for i in range(3):
        w.submit(_req(sv, i))
    w.close()
    with open(_seg(d), "ab") as f:
        f.write(b"\x40\x00\x00\x00\xde\xad\xbe\xefhalf a rec")


def sc_crc_corrupt(sv, j, d):
    w = j.JournalWriter(d)
    for i in range(3):
        w.submit(_req(sv, i))
    w.close()
    data = bytearray(open(_seg(d), "rb").read())
    data[-2] ^= 0xFF
    open(_seg(d), "wb").write(bytes(data))


def sc_mid_corruption(sv, j, d):
    sc_rotation(sv, j, d)
    first = os.path.join(d, "wal-00000001.seg")
    data = bytearray(open(first, "rb").read())
    data[len(data) // 2] ^= 0xFF
    open(first, "wb").write(bytes(data))


def sc_reopen(sv, j, d):
    w = j.JournalWriter(d)
    w.submit(_req(sv, 0))
    w.close()
    with open(_seg(d), "ab") as f:
        f.write(b"\x10\x00\x00\x00torn")
    w2 = j.JournalWriter(d)
    w2.submit(_req(sv, 1))
    w2.close()


def sc_unknown_records(sv, j, d):
    w = j.JournalWriter(d)
    w.submit(_req(sv, 0))
    w.append("FROM_THE_FUTURE", {"rid": 99}, flush=True)
    w.close()
    frame = json.dumps({"v": j.JOURNAL_VERSION + 1, "t": "SUBMIT",
                        "rid": 98}).encode()
    with open(_seg(d), "ab") as f:
        f.write(struct.pack("<II", len(frame), zlib.crc32(frame)) + frame)


def sc_crash_unflushed(sv, j, d):
    w = j.JournalWriter(d, fsync_boundaries=100)
    w.submit(_req(sv, 0))
    w.checkpoint(1, [_req(sv, 0, tokens=[1])])
    w.crash()


def sc_wal_torn_write(sv, j, d):
    fp = sv.FaultPlan.at(wal_torn_write=2)
    w = j.JournalWriter(d, faults=fp)
    for i in range(5):
        w.submit(_req(sv, i))
    w.close()
    assert fp.fires["wal_torn_write"] == 1


def sc_wal_lost_fsync(sv, j, d):
    fp = sv.FaultPlan.at(wal_lost_fsync=1)
    w = j.JournalWriter(d, faults=fp)
    for i in range(4):
        w.submit(_req(sv, i))
    w.close()
    assert fp.fires["wal_lost_fsync"] == 1


def sc_admit_restore(sv, j, d):
    req = _req(sv, 1, tokens=[5, 6])
    for sub, restore in (("a", False), ("b", True)):
        w = j.JournalWriter(os.path.join(d, sub))
        w.submit(req)
        w.admit(req, restore=False)
        w.checkpoint(1, [req])
        w.admit(req, restore=restore)
        w.close()


def sc_cluster_merge(sv, j, d):
    req = _req(sv, 1, tokens=[9, 9])
    w0 = j.JournalWriter(os.path.join(d, "r0"))
    w0.submit(req)
    w0.admit(req, restore=False)
    w0.checkpoint(1, [req])
    w0.close()
    w1 = j.JournalWriter(os.path.join(d, "r1"))
    w1.admit(req, restore=True)
    w1.complete(req)
    w1.close()


def sc_dead_letters(sv, j, d):
    w = j.JournalWriter(d)
    w.dead_letter(sv.RequestFailed(
        rid=3, tenant="t", reason="boom", boundary=7, retries=4,
        site="alloc", ckpt_tokens=2).record())
    w.dead_letter(sv.ReplicaLost(
        rid=4, tenant="t", reason="gone", boundary=8, retries=1,
        site="replica_crash", ckpt_tokens=0, replica="r1").record())
    w.close()


def sc_spilled_image(sv, j, d):
    """An fp32 image, then a bf16 writer's image (the port's int16
    patterns named ``bfloat16``; the JAX package's ml_dtypes array)."""
    bits = np.arange(48, dtype=np.uint16).reshape(2, 3, 2, 4) * 97
    host = bits.view(ml_dtypes.bfloat16) if sv is jsv else \
        bits.view(np.int16)
    for sub, k, dt in (("f32", np.linspace(-1, 1, 48, dtype=np.float32)
                        .reshape(2, 3, 2, 4), None),
                       ("bf16", host, "bfloat16")):
        w = j.JournalWriter(os.path.join(d, sub))
        w.image_dtype = dt
        req = _req(sv, 1, tokens=[3, 4])
        w.submit(req)
        req.swap = sv.SwapState(pages=[1, 2, 3], n_tokens=6, slot=0,
                                host_k=k, host_v=k[::-1].copy(),
                                checksum=7)
        w.spill_image(req)
        w.close()


SCENARIOS = {
    "lifecycle": (sc_lifecycle, lambda rp: rp.requests[1].tokens
                  == [7, 8, 9, 10, 11] and not rp.truncated),
    "rotation": (sc_rotation, lambda rp: sorted(rp.requests)
                 == list(range(30)) and not rp.truncated),
    "torn_tail": (sc_torn_tail, lambda rp: rp.truncated
                  and sorted(rp.requests) == [0, 1, 2]),
    "crc_corrupt": (sc_crc_corrupt, lambda rp: rp.truncated
                    and sorted(rp.requests) == [0, 1]),
    "mid_corruption": (sc_mid_corruption, lambda rp: rp.truncated
                       and sorted(rp.requests)
                       == list(range(len(rp.requests))) < list(range(30))),
    "reopen": (sc_reopen, lambda rp: not rp.truncated
               and sorted(rp.requests) == [0, 1]),
    "unknown_records": (sc_unknown_records, lambda rp: rp.n_skipped == 2
                        and sorted(rp.requests) == [0]),
    "crash_unflushed": (sc_crash_unflushed, lambda rp:
                        rp.requests[0].status == "submitted"
                        and rp.requests[0].n_tokens == 0),
    "wal_torn_write": (sc_wal_torn_write, lambda rp: rp.truncated
                       and sorted(rp.requests) == [0, 1]),
    "wal_lost_fsync": (sc_wal_lost_fsync, lambda rp: not rp.truncated
                       and sorted(rp.requests) == [0, 2, 3]),
    "admit_restore": (sc_admit_restore, lambda rp:
                      rp.requests[1].status == "running"),
    "cluster_merge": (sc_cluster_merge, lambda rp:
                      rp.requests[1].status == "completed"
                      and rp.requests[1].prompt == [0, 1, 2, 3]),
    "dead_letters": (sc_dead_letters, lambda rp: sorted(rp.requests)
                     == [3, 4]),
    "spilled_image": (sc_spilled_image, lambda rp:
                      rp.requests[1].status == "swapped"),
}


def _replay_fields(rp):
    return {"state": rp.state(), "truncated": rp.truncated,
            "n_records": rp.n_records, "n_skipped": rp.n_skipped,
            "plan": rp.plan,
            "requests": {rid: {k: v for k, v in
                               dataclasses.asdict(r).items()
                               if k != "image_file"}
                         for rid, r in rp.requests.items()}}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_journal_bytes_and_replay_equal_jax(tmp_path, name):
    """The same operations through either package's writer leave the same
    bytes on disk, and either directory replays to the same state through
    either package's reader."""
    scenario, check = SCENARIOS[name]
    dirs = {}
    for side, (sv, j) in PKGS.items():
        dirs[side] = str(tmp_path / side)
        scenario(sv, j, dirs[side])
    assert _files(dirs["torch"]) == _files(dirs["jax"])
    replays = [_replay_fields(j.replay_journal(dirs[w]))
               for w in PKGS for _, j in PKGS.values()]
    assert all(r == replays[0] for r in replays)
    rp = tj.replay_journal(dirs["jax"])
    assert check(rp)
    assert tj.replay_journal(dirs["jax"]).state() == rp.state()  # pure read
    if name == "admit_restore":
        for sub, n in (("a", 0), ("b", 2)):
            assert tj.replay_journal(os.path.join(dirs["jax"], sub)) \
                .requests[1].n_tokens == n
    if name == "dead_letters":
        rr = {side: j.RestartRecovery(dirs["jax"])
              for side, (_, j) in PKGS.items()}
        for rid in (3, 4):
            f = {side: r._failure(r.replay.requests[rid].failure)
                 for side, r in rr.items()}
            assert f["torch"].record() == f["jax"].record()
            assert type(f["torch"]).__name__ == type(f["jax"]).__name__


def test_closed_writer_raises(tmp_path):
    w = tj.JournalWriter(str(tmp_path))
    w.close()
    with pytest.raises(tj.JournalError):
        w.submit(_req(tsv, 0))


# ------------------------------------------------------------ bf16 images
def _bf16_pages(seed):
    bits = np.random.default_rng(seed).integers(
        0, 2 ** 16, (2, 3, 4, 1, 8)).astype(np.uint16)
    return bits & 0x7F7F                    # finite values only


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_bf16_image_round_trips_both_ways(tmp_path, writer):
    """A bf16 swap image written by either package loads in both with
    equal bytes, shape and checksum: the port as int16 patterns, the JAX
    package as ml_dtypes bfloat16."""
    k, v = _bf16_pages(1), _bf16_pages(2)
    path = str(tmp_path / "img-00000000.npz")
    if writer == "jax":
        jj._save_image(path, k.view(ml_dtypes.bfloat16),
                       v.view(ml_dtypes.bfloat16))
    else:
        tj._save_image(path, k.view(np.int16), v.view(np.int16),
                       "bfloat16")
    tk, tv = tj._load_image(path)
    jk, jv = jj._load_image(path)
    assert tk.dtype == np.int16 and jk.dtype == ml_dtypes.bfloat16
    for a, b, want in ((tk, jk, k), (tv, jv, v)):
        assert a.shape == b.shape == want.shape
        assert a.tobytes() == b.tobytes() == want.tobytes()
    assert image_checksum(tk, tv) == jax_checksum(jk, jv)
    with np.load(path) as z:
        assert [str(m) for m in z["k_meta"]][0] == "bfloat16"


def test_bf16_engine_image_restores_across_packages(tmp_path):
    """The port's engine swaps out bf16 pages, its journal spills them,
    and the JAX reader's image scatters back to the same device values
    through the port's restore (and the reverse): bit for bit."""
    bits = _bf16_pages(3)
    pool = torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)
    eng = tsv.PagedServingEngine.__new__(tsv.PagedServingEngine)
    eng.device, eng.cache_dtype = torch.device("cpu"), torch.bfloat16
    req = _req(tsv, 5, tokens=[1])
    req.swap = tsv.SwapState(pages=[2, 0, 1], n_tokens=20, slot=0)
    eng._swap_out({"blocks": {"k_pages": pool, "v_pages": pool}}, req.swap)
    d = str(tmp_path)
    w = tj.JournalWriter(d)
    w.image_dtype = "bfloat16"          # as the engine's EngineRun sets it
    w.submit(req)
    w.spill_image(req)
    w.close()
    for j in (jj, tj):
        r = j.replay_journal(d).requests[5]
        assert r.image_checksum == req.swap.checksum
        sw = j.RestartRecovery(d)._load_image(r)
        assert image_checksum(np.asarray(sw.host_k).view(np.int16),
                              np.asarray(sw.host_v).view(np.int16)) \
            == req.swap.checksum
        host = np.asarray(sw.host_k).view(np.int16)
        back = torch.from_numpy(host.copy()).view(torch.bfloat16)
        assert torch.equal(back.view(torch.int16),
                           pool[:, [2, 0, 1]].view(torch.int16))


# --------------------------------------------------- engines, end to end
_E = {}


def _pair():
    """fp32 qwen2-smoke in both packages on the JAX init (one compiled
    JAX engine per geometry, shared by every test here)."""
    if "pair" not in _E:
        jcfg = jax_config("qwen2_7b", smoke=True).replace(
            act_dtype="float32")
        tcfg = get_config("qwen2_7b", smoke=True).replace(
            act_dtype="float32")
        jm = jax_build(jcfg, policy=JaxPolicy(default="fp32"))
        tm = build_model(tcfg, policy=PrecisionPolicy(default="fp32"),
                         device="cpu")
        params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
        lm = tm.empty_params()
        lm.load_state_dict(params_from_jax(params))
        _E["pair"] = (jm, jax.tree.map(jnp.asarray, params), tm, lm)
    return _E["pair"]


# a pool of 7 allocatable pages for two 5-page lifetimes: preemptions,
# host swaps and spilled images mid-burst
PCFG = dict(page_size=8, n_pages=8, max_slots=2, max_blocks=5,
            segment_len=4)


def _engines(durability=None):
    """(JAX engine, port engine), both with an fp32 cache."""
    jm, _, tm, _ = _pair()
    if "jax" not in _E:
        _E["jax"] = jsv.PagedServingEngine(
            jm, jsv.PagedCacheConfig(**PCFG), cache_dtype=jnp.float32)
    jeng = _E["jax"]
    teng = tsv.PagedServingEngine(tm, tsv.PagedCacheConfig(**PCFG),
                                  cache_dtype=torch.float32)
    if durability is not None:
        teng = tsv.PagedServingEngine.from_plan(tm, dataclasses.replace(
            teng.plan, durability=tsv.DurabilityPolicy(**durability)))
        plan = dataclasses.replace(jeng.plan, durability=jsv.DurabilityPolicy(
            **durability))
        base = jeng
        jeng = jsv.PagedServingEngine.from_plan(jm, plan)
        for fn in ("_prefill", "_write_pages", "_admit_batch", "_segment"):
            setattr(jeng, fn, getattr(base, fn))
    return jeng, teng


def _burst(sv, n=3, gen=24):
    rng = np.random.default_rng(0)
    vocab = _pair()[2].cfg.vocab_size
    return [sv.Request(rid=i, prompt=rng.integers(0, vocab, size=12)
                       .astype(np.int32), max_new_tokens=gen)
            for i in range(n)]


def _oracle():
    """The JAX engine's fault-free greedy tokens."""
    if "oracle" not in _E:
        jeng, _ = _engines()
        reqs = _burst(jsv)
        st = jeng.run(reqs, _pair()[1])
        assert st["preemptions"] >= 1
        _E["oracle"] = {r.rid: list(r.tokens) for r in reqs}
    return _E["oracle"]


def _tokens(out):
    return {r.rid: list(r.tokens) for r in out["requests"]
            if r.failure is None}


def _no_images(d):
    return not [f for f in _files(d) if "img-" in f]


def test_fault_free_journaled_run_replays_completed(tmp_path):
    d = str(tmp_path)
    _, teng = _engines(dict(enabled=True, journal_dir=d))
    reqs = _burst(tsv)
    st = teng.run(reqs, _pair()[3])
    assert st["journal"]["n_appended"] > 0 and st["journal"]["n_spilled"]
    assert {r.rid: list(r.tokens) for r in reqs} == _oracle()
    for j in (tj, jj):
        rp = j.replay_journal(d)
        assert not rp.truncated
        assert {rid: r.tokens for rid, r in rp.requests.items()} \
            == _oracle()
    assert _no_images(d)


@pytest.mark.parametrize("crash_at", [3, 5, 8])
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_crash_journal_finishes_in_the_other_package(tmp_path, writer,
                                                    crash_at):
    """Crash either engine mid-burst; both packages replay the directory
    to the same state, and the OTHER package's RestartRecovery finishes
    every request with the JAX oracle's tokens, leaving no image."""
    jm, jparams, tm, lm = _pair()
    d = str(tmp_path)
    jeng, teng = _engines(dict(enabled=True, journal_dir=d))
    sv, eng, params = (jsv, jeng, jparams) if writer == "jax" \
        else (tsv, teng, lm)
    with pytest.raises(sv.ProcessCrashed):
        eng.run(_burst(sv), params,
                faults=sv.FaultPlan.at(process_crash=crash_at))
    assert _replay_fields(tj.replay_journal(d)) == \
        _replay_fields(jj.replay_journal(d))
    if writer == "jax":
        out = tj.RestartRecovery(d).resume(tm, lm)   # plan JSON rebuild
    else:
        out = jj.RestartRecovery(d).resume(jm, jparams,
                                           engine=_engines()[0])
    assert _tokens(out) == _oracle()
    assert _no_images(d)
    for j in (tj, jj):
        assert all(r.status in ("completed", "dead")
                   for r in j.replay_journal(d).requests.values())


@pytest.mark.parametrize("crash_at", [2, 5])
def test_crash_restart_tokens_equal_jax_oracle(tmp_path, crash_at):
    d = str(tmp_path)
    _, teng = _engines(dict(enabled=True, journal_dir=d))
    _, _, tm, lm = _pair()
    with pytest.raises(tsv.ProcessCrashed):
        teng.run(_burst(tsv), lm,
                 faults=tsv.FaultPlan.at(process_crash=crash_at))
    out = tj.RestartRecovery(d).resume(tm, lm, engine=_engines()[1])
    assert _tokens(out) == _oracle()
    assert _no_images(d)
    assert out["recovered"]["truncated_tail"] is False


def test_truncated_tail_degrades_to_restart(tmp_path):
    """Bytes chopped off the post-crash tail: replay drops the damage and
    every acknowledged request still finishes with the oracle's tokens,
    in both packages' replays alike."""
    d = str(tmp_path)
    _, teng = _engines(dict(enabled=True, journal_dir=d))
    _, _, tm, lm = _pair()
    with pytest.raises(tsv.ProcessCrashed):
        teng.run(_burst(tsv), lm,
                 faults=tsv.FaultPlan.at(process_crash=5))
    path = _seg(d)
    with open(path, "r+b") as f:
        f.truncate(max(0, os.path.getsize(path) - 7))
    assert _replay_fields(tj.replay_journal(d)) == \
        _replay_fields(jj.replay_journal(d))
    rr = tj.RestartRecovery(d)
    assert rr.replay.truncated
    acked = set(rr.replay.requests)
    out = rr.resume(tm, lm, engine=_engines()[1])
    oracle = _oracle()
    assert _tokens(out) == {rid: oracle[rid] for rid in acked}


def test_resume_journals_into_same_dir(tmp_path):
    d = str(tmp_path)
    _, teng = _engines(dict(enabled=True, journal_dir=d))
    _, _, tm, lm = _pair()
    with pytest.raises(tsv.ProcessCrashed):
        teng.run(_burst(tsv), lm,
                 faults=tsv.FaultPlan.at(process_crash=3))
    n_before = tj.replay_journal(d).n_records
    tj.RestartRecovery(d).resume(tm, lm, engine=_engines()[1])
    rp = tj.replay_journal(d)
    assert rp.n_records > n_before
    out2 = tj.RestartRecovery(d).resume(tm, lm, engine=_engines()[1])
    c = out2["recovered"]
    assert c["replayed_completed"] + c["replayed_dead"] == len(rp.requests)
    assert _tokens(out2) == _oracle()


def test_durable_cluster_crash_restart_equals_jax_oracle(tmp_path):
    """A two-replica cluster journals per replica; a process crash and a
    cold restart from plan.json + the merged streams finish with the
    tokens of the JAX package's cluster on the same requests."""
    jm, jparams, tm, lm = _pair()
    jeng, _ = _engines()
    jreqs = _burst(jsv, n=5)
    jsv.ServingCluster(jeng, jparams, n_replicas=2).run(jreqs)
    oracle = {r.rid: list(r.tokens) for r in jreqs}
    d = str(tmp_path)
    _, teng = _engines(dict(enabled=True, journal_dir=d))
    cl = tsv.ServingCluster(teng, lm, n_replicas=2,
                            faults=tsv.FaultPlan.at(process_crash=4))
    with pytest.raises(tsv.ProcessCrashed):
        cl.run(_burst(tsv, n=5))
    assert os.path.isdir(os.path.join(d, "r0"))
    assert _replay_fields(tj.replay_journal(d)) == \
        _replay_fields(jj.replay_journal(d))
    out = tj.RestartRecovery(d).resume(tm, lm)
    assert _tokens(out) == oracle
    assert _no_images(d)
