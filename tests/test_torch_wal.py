"""The port's write-ahead log (`repro_torch.serve.wal`) against the
reference's: the same records give byte-identical segments, each package
reads the other's log, and torn or corrupt tails truncate identically.
"""

import os

import numpy as np
import pytest

from repro.serve import wal as ref_wal
from repro_torch.serve import wal

PKGS = {"ref": ref_wal, "port": wal}


def _records(rng, n=9, dim=5):
    out = []
    for i in range(n):
        if i % 3 == 2:
            out.append(("delete", rng.integers(0, 50, 4).astype(np.int64)))
        else:
            k = int(rng.integers(1, 4))
            out.append(("insert", np.arange(10 * i, 10 * i + k, dtype=np.int64),
                        rng.standard_normal((k, dim)).astype(np.float32)))
    return out


def _write(pkg, d, recs, segment_bytes):
    log = pkg.WriteAheadLog(pkg.WalConfig(dir=str(d),
                                          segment_bytes=segment_bytes))
    lsns = []
    for r in recs:
        lsns.append(log.append_insert(r[1], r[2]) if r[0] == "insert"
                    else log.append_delete(r[1]))
        if len(lsns) % 2 == 0:
            log.sync()
    log.close()
    return lsns


def _files(d):
    return {n: (d / n).read_bytes() for n in sorted(os.listdir(d))}


def _same_records(got, want):
    assert [(r.lsn, r.kind) for r in got] == [(r.lsn, r.kind) for r in want]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.ext_ids, b.ext_ids)
        assert a.ext_ids.dtype == b.ext_ids.dtype
        if b.vectors is None:
            assert a.vectors is None
        else:
            np.testing.assert_array_equal(a.vectors, b.vectors)
            assert a.vectors.dtype == b.vectors.dtype


@pytest.mark.parametrize("segment_bytes", [4 << 20, 96])
def test_same_records_give_byte_identical_segments(tmp_path, segment_bytes):
    recs = _records(np.random.default_rng(0))
    dirs = {k: tmp_path / k for k in PKGS}
    lsns = {k: _write(pkg, dirs[k], recs, segment_bytes)
            for k, pkg in PKGS.items()}
    assert lsns["port"] == lsns["ref"] == list(range(1, len(recs) + 1))
    want = _files(dirs["ref"])
    # one segment, or several where the small segments drove rotation
    assert (len(want) == 1) == (segment_bytes > 1000)
    assert _files(dirs["port"]) == want


@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref")])
def test_each_package_reads_the_others_log(tmp_path, writer, reader):
    recs = _records(np.random.default_rng(1))
    _write(PKGS[writer], tmp_path, recs, 128)
    log = PKGS[reader].WriteAheadLog(PKGS[reader].WalConfig(dir=str(tmp_path)))
    other = PKGS[writer].WriteAheadLog(PKGS[writer].WalConfig(
        dir=str(tmp_path)))
    _same_records(log.records(), other.records())
    assert len(log.records()) == len(recs)
    assert log.records(after=4) == log.records()[4:]
    assert log.last_lsn == other.last_lsn == len(recs)


def _tear(path, how):
    data = bytearray(path.read_bytes())
    if how == "torn":           # the crash landed mid-record
        data = data[:-7]
    elif how == "corrupt":      # a flipped byte in the last record's payload
        data[-3] ^= 0xFF
    else:                       # garbage past the last whole record
        data += b"\x01\x02\x03"
    path.write_bytes(bytes(data))


@pytest.mark.parametrize("how", ["torn", "corrupt", "trailing"])
def test_torn_and_corrupt_tails_truncate_identically(tmp_path, how):
    recs = _records(np.random.default_rng(2))
    dirs = {k: tmp_path / k for k in PKGS}
    logs = {}
    for k, pkg in PKGS.items():
        _write(pkg, dirs[k], recs, 160)
        segs = sorted(os.listdir(dirs[k]))
        assert len(segs) > 2
        # tear the middle segment: every later one must go too
        _tear(dirs[k] / segs[1], how)
        logs[k] = pkg.WriteAheadLog(pkg.WalConfig(dir=str(dirs[k])))
    assert _files(dirs["port"]) == _files(dirs["ref"])
    _same_records(logs["port"].records(), logs["ref"].records())
    assert logs["port"].last_lsn == logs["ref"].last_lsn < len(recs)
    # appends after recovery continue the chain the same way
    for k, pkg in PKGS.items():
        logs[k].append_delete(np.array([7], np.int64))
        logs[k].close()
    assert _files(dirs["port"]) == _files(dirs["ref"])


def test_truncate_through_drops_the_same_segments(tmp_path):
    recs = _records(np.random.default_rng(3), n=12)
    dirs = {k: tmp_path / k for k in PKGS}
    for k, pkg in PKGS.items():
        log = pkg.WriteAheadLog(pkg.WalConfig(dir=str(dirs[k]),
                                              segment_bytes=160))
        for r in recs:
            if r[0] == "insert":
                log.append_insert(r[1], r[2])
            else:
                log.append_delete(r[1])
        log.sync()
        assert log.truncate_through(7) > 0
        log.close()
    assert _files(dirs["port"]) == _files(dirs["ref"])
    for k, pkg in PKGS.items():
        log = pkg.WriteAheadLog(pkg.WalConfig(dir=str(dirs[k])))
        assert min(r.lsn for r in log.records()) <= 8
        assert log.last_lsn == len(recs)
