"""The durable journal and warm restart on the port's Engine, held against
the JAX Engine.

The cells of ``tests/test_warm_restart.py`` for the ``lm`` family, on
gemma-2b smoke (``torch_parity.lifecycle_makers``): ``BlobLog``'s framing
(round trip, reopen, torn tail, mid-file corruption, the follower's
in-flight and corrupt frames) and byte-identical journal files from the
port's and the reference's ``BlobLog``; a crash (``InjectedCrash``) at
every block round of a run, recovered into a fresh Engine from the durable
directory, on the dense and the paged cache (f32) and the paged cache with
int8 weights: the recovered ``done`` equals the uninterrupted port run's
and the JAX Engine's recovered ``done``; journal-only recovery; a
recovered Engine serving new work; ``recover`` refused on a durable
Engine; the prefix index warm after a restart.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_parity import (auto_mesh, drain, lifecycle_makers,  # noqa: E402
                          rand_prompts)
# every reference Engine of the module reuses the XLA executables of
# the ones before it (torch_parity.reuse_xla_executables)
from torch_parity import reuse_executables  # noqa: E402,F401

from repro.dist.constrain import use_mesh  # noqa: E402

PAGED = dict(paged=True, page_size=4, num_pages=16)
PRIOS = ("batch", "realtime", None, "standard")


def _pkg(pkg):
    """(BlobLog, ServingFaultInjector, CRASH_KIND, InjectedCrash,
    RequestStatus) of ``pkg``."""
    if pkg == "jax":
        from repro.checkpoint.store import BlobLog
        from repro.ft import CRASH_KIND, InjectedCrash, ServingFaultInjector
        from repro.launch.lifecycle import RequestStatus
    else:
        from repro_torch.checkpoint.store import BlobLog
        from repro_torch.ft import (CRASH_KIND, InjectedCrash,
                                    ServingFaultInjector)
        from repro_torch.launch.lifecycle import RequestStatus
    return BlobLog, ServingFaultInjector, CRASH_KIND, InjectedCrash, \
        RequestStatus


def _both(scenario, tmp_path, mode="none"):
    """``scenario(make, pkg, cfg, directory)`` on the JAX Engine and on the
    port's; the results must be equal.  Returns the port's."""
    cfg, make = lifecycle_makers(mode)
    with use_mesh(auto_mesh()):
        want = scenario(make["jax"], "jax", cfg, tmp_path / "jax")
    got = scenario(make["torch"], "torch", cfg, tmp_path / "torch")
    assert got == want
    return got


def _drive(eng, prompts, *, gen_len=6, block=4, prios=None):
    for i, p in enumerate(prompts):
        eng.submit(p, gen_len=gen_len,
                   priority=None if prios is None else prios[i])
    eng.try_admit()
    return drain(eng, block)


def _crash_recover(make, pkg, prompts, directory, crash_round, *,
                   snapshot_every=2, gen_len=6, block=4, prios=None, **kw):
    """Run durably, die at ``crash_round``, recover a fresh Engine (same
    arguments, no ``durable_dir``, no injector) and finish the work."""
    _, Injector, crash, InjectedCrash, _ = _pkg(pkg)
    kw.setdefault("batch", 2)
    kw.setdefault("max_len", 32)
    eng = make(durable_dir=str(directory), snapshot_every=snapshot_every,
               fault_injector=Injector({crash_round: crash}), **kw)
    with pytest.raises(InjectedCrash):
        _drive(eng, prompts, gen_len=gen_len, block=block, prios=prios)
    eng2 = make(**kw)
    info = eng2.recover(str(directory))
    drain(eng2, block)
    return eng2, info


# ===========================================================================
class TestBlobLog:
    @pytest.mark.parametrize("pkg", ["jax", "torch"])
    def test_append_read_reopen(self, tmp_path, pkg):
        BlobLog = _pkg(pkg)[0]
        path = str(tmp_path / "j.log")
        log = BlobLog(path)
        recs = [("submit", {"id": 0}), ("block", 4), ("retire",)]
        assert [log.append(r) for r in recs] == [0, 1, 2]
        assert log.read() == recs and log.read(1) == recs[1:]
        log.close()
        log2 = BlobLog(path)
        assert log2.count == 3
        log2.append("c")
        assert log2.read() == recs + ["c"]
        log2.close()
        assert BlobLog(path, fresh=True).read() == []

    def test_port_and_reference_write_the_same_bytes(self, tmp_path):
        """The same records appended through both logs give byte-identical
        files, and each reads the other's."""
        from repro.checkpoint.store import BlobLog as JLog
        from repro_torch.checkpoint.store import BlobLog as TLog
        recs = [("submit", {"id": 0, "prompt": np.arange(5, dtype=np.int32),
                            "gen_len": 6, "temperature": 0.0, "top_k": 0,
                            "deadline_s": None, "priority": "batch"}),
                ("admit",), ("block", 4), ("finish", 1, "completed"),
                ("retire",), ("cancel", 3)]
        paths = {}
        for name, cls in (("jax", JLog), ("torch", TLog)):
            log = cls(str(tmp_path / f"{name}.log"))
            for r in recs:
                log.append(r)
            log.close()
            paths[name] = tmp_path / f"{name}.log"
        assert paths["jax"].read_bytes() == paths["torch"].read_bytes()
        back = TLog(str(paths["jax"])).read()
        assert repr(back) == repr(recs)

    @pytest.mark.parametrize("pkg", ["jax", "torch"])
    def test_torn_tail_is_truncated_on_open(self, tmp_path, pkg):
        BlobLog = _pkg(pkg)[0]
        path = str(tmp_path / "j.log")
        log = BlobLog(path)
        log.append("kept-1")
        log.append("kept-2")
        log.close()
        size = os.path.getsize(path)
        with open(path, "ab") as f:
            f.write(b"\x40\x00\x00\x00\x99")   # header + 1 of 64 bytes
        log2 = BlobLog(path)
        assert log2.count == 2 and log2.read() == ["kept-1", "kept-2"]
        log2.close()
        assert os.path.getsize(path) == size

    @pytest.mark.parametrize("pkg", ["jax", "torch"])
    def test_mid_file_corruption_is_refused(self, tmp_path, pkg):
        BlobLog = _pkg(pkg)[0]
        path = str(tmp_path / "j.log")
        log = BlobLog(path)
        log.append("one")
        off = os.path.getsize(path)
        log.append("two" * 10)
        log.close()
        with open(path, "r+b") as f:
            f.seek(off + 8)
            b = f.read(1)
            f.seek(off + 8)
            f.write(bytes([b[0] ^ 0xFF]))      # CRC now mismatches
        with open(path, "ab") as f:
            f.write(b"x" * 64)                 # data after the break
        with pytest.raises(IOError, match="corrupt"):
            BlobLog(path)

    @pytest.mark.parametrize("pkg", ["jax", "torch"])
    def test_enlarged_length_before_valid_frame_is_refused(self, tmp_path,
                                                           pkg):
        """The second net: a flipped length field that swallows every
        later record as one 'torn' frame is caught by the complete valid
        frame inside it."""
        BlobLog = _pkg(pkg)[0]
        path = str(tmp_path / "j.log")
        log = BlobLog(path)
        log.append("one")
        off = os.path.getsize(path)
        log.append("two")
        log.append("three")
        log.close()
        data = bytearray(open(path, "rb").read())
        data[off:off + 4] = (10_000).to_bytes(4, "little")
        open(path, "wb").write(bytes(data))
        with pytest.raises(IOError, match="valid frame"):
            BlobLog(path)

    @pytest.mark.parametrize("pkg", ["jax", "torch"])
    def test_follower_waits_for_short_frame_and_refuses_bad_crc(
            self, tmp_path, pkg):
        BlobLog = _pkg(pkg)[0]
        path = str(tmp_path / "j.log")
        log = BlobLog(path)
        fol = log.follow()
        assert fol.poll() == []
        log.append("a")
        log.append("b")
        assert fol.poll(max_records=1) == ["a"]
        assert fol.poll() == ["b"] and fol.count == 2
        good = os.path.getsize(path)
        with open(path, "ab") as f:            # an append in flight
            f.write(b"\x10\x00\x00\x00")
        assert fol.poll() == [] and fol.offset == good
        with open(path, "ab") as f:            # completes, wrong CRC
            f.write(b"\x00\x00\x00\x00" + b"z" * 16)
        with pytest.raises(IOError, match="CRC"):
            fol.poll()
        log.close()


# ===========================================================================
CELLS = [("dense", "none"), ("paged", "none"), ("paged", "int8")]


@pytest.mark.parametrize("cache,mode", CELLS,
                         ids=[f"{c}-{m}" for c, m in CELLS])
def test_crash_at_every_round(tmp_path, cache, mode):
    """A crash at every block round, recovered into a fresh Engine: the
    recovered ``done`` (content and order) equals the uninterrupted run's,
    every request COMPLETED, on both Engines, which agree."""
    kw = dict(PAGED) if cache == "paged" else {}

    def scenario(make, pkg, cfg, directory):
        status = _pkg(pkg)[4]
        prompts = rand_prompts(cfg.vocab, (9, 5, 12, 3), seed=31)
        clean = _drive(make(batch=2, max_len=32, **kw), prompts,
                       prios=PRIOS)
        assert clean._round >= 3
        out = []
        for rnd in range(1, clean._round + 1):
            rec, info = _crash_recover(make, pkg, prompts, directory / str(rnd),
                                       rnd, prios=PRIOS, **kw)
            assert rec.done == clean.done, f"diverged for a crash at {rnd}"
            assert all(r["status"] is status.COMPLETED
                       for r in rec.results.values())
            out.append((rec.done, info["snapshot_step"], info["replayed"],
                        rec.counters["recoveries"]))
        return clean.done, out

    _both(scenario, tmp_path, mode)


def test_journal_only_recovery_before_first_snapshot(tmp_path):
    """``snapshot_every=0``: no snapshot lands; the whole history replays
    from the journal, which stays on after recovery."""
    def scenario(make, pkg, cfg, directory):
        prompts = rand_prompts(cfg.vocab, (9, 5, 12), seed=32)
        clean = _drive(make(batch=2, max_len=32), prompts)
        rec, info = _crash_recover(make, pkg, prompts, directory, 2,
                                   snapshot_every=0)
        assert rec.done == clean.done
        assert info["snapshot_step"] is None
        assert rec._journal.count > info["replayed"] > 0
        return rec.done, info

    _both(scenario, tmp_path)


def test_recovered_engine_serves_new_requests(tmp_path):
    def scenario(make, pkg, cfg, directory):
        prompts = rand_prompts(cfg.vocab, (9, 5), seed=33)
        rec, _ = _crash_recover(make, pkg, prompts, directory, 2)
        before = rec._journal.count
        extra = rand_prompts(cfg.vocab, (7,), seed=34)
        solo = _drive(make(batch=2, max_len=32), extra)
        _drive(rec, extra)
        assert rec.done[-1] == solo.done[0]
        assert rec._journal.count > before
        return rec.done

    _both(scenario, tmp_path)


def test_recover_on_durable_engine_is_refused(tmp_path):
    cfg, make = lifecycle_makers()
    eng = make["torch"](batch=2, max_len=32, durable_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="durable_dir"):
        eng.recover(str(tmp_path))


def test_crash_releases_the_dead_engine(tmp_path):
    """The crashed Engine of this process gives its cache, graphs, params
    and journal back where it dies, and another Engine recovers its
    directory."""
    cfg, make = lifecycle_makers()
    mk = make["torch"]
    from repro_torch.ft import InjectedCrash, ServingFaultInjector
    prompts = rand_prompts(cfg.vocab, (9, 5), seed=37)
    clean = _drive(mk(batch=2, max_len=32), prompts)
    dead = mk(batch=2, max_len=32, durable_dir=str(tmp_path),
              fault_injector=ServingFaultInjector({2: "crash"}))
    with pytest.raises(InjectedCrash):
        _drive(dead, prompts)
    assert dead.cache is None and dead.params is None
    assert dead._journal._f.closed
    rec = mk(batch=2, max_len=32)
    rec.recover(str(tmp_path))
    assert drain(rec, 4).done == clean.done


def test_prefix_index_survives_restart(tmp_path):
    """Committed prompt pages are durable state: after recovery a shared
    preamble hits the index instead of prefilling again."""
    kw = dict(paged=True, page_size=4, num_pages=32, prefix_cache=True)

    def scenario(make, pkg, cfg, directory):
        rs = np.random.RandomState(35)
        pre = rs.randint(0, cfg.vocab, (16,))
        prompts = [np.concatenate([pre, rs.randint(0, cfg.vocab, (3,))])
                   for _ in range(3)]
        clean = _drive(make(batch=2, max_len=32, **kw), prompts)
        rec, _ = _crash_recover(make, pkg, prompts, directory, 3, **kw)
        assert rec.done == clean.done
        assert len(rec.prefix_index) > 0
        hits = rec.counters["prefix_hits"]
        _drive(rec, [np.concatenate([pre, rs.randint(0, cfg.vocab, (3,))])])
        assert rec.counters["prefix_hits"] > hits
        return rec.done, rec.counters["prefix_hits"], len(rec.prefix_index)

    _both(scenario, tmp_path)
