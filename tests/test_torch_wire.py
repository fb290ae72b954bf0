"""PyTorch port, the head↔worker wire: ``transport.wire`` and the FIFO
transfer scripts against the JAX package's. Held equal byte for byte:
``RuntimeConfig``/``Request``/``StatsRow``/``HealthStatus`` lines (the
``FAIL``/``STALE_*`` sentinels included), each package decoding the
other's lines, the transfer and ping scripts, and the query, paths and
results files."""

import dataclasses

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401  (one intra-op thread)

from distributed_oracle_search_tpu.transport import fifo as j_fifo  # noqa: E402
from distributed_oracle_search_tpu.transport import wire as j_wire  # noqa: E402
from distributed_oracle_search_tpu_torch.transport import fifo as t_fifo  # noqa: E402
from distributed_oracle_search_tpu_torch.transport import wire as t_wire  # noqa: E402

WIRE = {"jax": j_wire, "torch": t_wire}

ints = st.integers(-2**40, 2**40)
small = st.integers(0, 2**31 - 1)
floats = st.floats(allow_nan=False, allow_infinity=False, width=64)
text = st.text(st.characters(blacklist_categories=("Cs",)), max_size=20)
tokens = st.text(st.sampled_from("abcXYZ019_./-"), min_size=1, max_size=30)


def _config_kwargs():
    return st.fixed_dictionaries({
        "hscale": floats, "fscale": floats, "time": small, "itrs": small,
        "k_moves": st.integers(-1, 10_000), "threads": small,
        "verbose": st.integers(0, 5), "debug": st.booleans(),
        "thread_alloc": small, "no_cache": st.booleans(),
        "extract": st.booleans(), "trace_id": text,
        "results": st.booleans(), "epoch": small, "diff_epoch": small,
        "sig_k": small, "answer_fp": st.booleans(),
    })


def test_same_fields_and_constants():
    for cls in ("RuntimeConfig", "Request", "StatsRow", "HealthStatus"):
        jf = [(f.name, f.default) for f in
              dataclasses.fields(getattr(j_wire, cls))]
        tf = [(f.name, f.default) for f in
              dataclasses.fields(getattr(t_wire, cls))]
        assert tf == jf, cls
    for name in ("ENGINE_STAT_FIELDS", "HEAD_STAT_FIELDS", "STATS_HEADER",
                 "FAIL_LINE", "STALE_EPOCH_LINE", "STALE_DIFF_LINE",
                 "PING_TOKEN"):
        assert getattr(t_wire, name) == getattr(j_wire, name), name
    from distributed_oracle_search_tpu.worker.server import STOP_TOKEN
    assert t_wire.STOP_TOKEN == STOP_TOKEN
    assert t_fifo.DEFAULT_TIMEOUT == j_fifo.DEFAULT_TIMEOUT
    assert t_fifo.command_fifo_path(3) == j_fifo.command_fifo_path(3)
    assert (t_fifo.answer_fifo_path("/nfs/", "h", 2)
            == j_fifo.answer_fifo_path("/nfs/", "h", 2))


@settings(max_examples=60, deadline=None)
@given(kw=_config_kwargs())
def test_runtime_config_lines_equal(kw):
    jc, tc = j_wire.RuntimeConfig(**kw), t_wire.RuntimeConfig(**kw)
    assert tc.to_json() == jc.to_json()
    assert t_wire.RuntimeConfig.from_json(jc.to_json()) == tc
    assert j_wire.RuntimeConfig.from_json(tc.to_json()) == jc


def test_runtime_config_drops_unknown_keys():
    line = '{"hscale": 2.0, "future_knob": 1, "k_moves": 5}'
    tc = t_wire.RuntimeConfig.from_json(line)
    assert tc.hscale == 2.0 and tc.k_moves == 5
    assert tc.to_json() == j_wire.RuntimeConfig.from_json(line).to_json()


@settings(max_examples=60, deadline=None)
@given(kw=_config_kwargs(), qf=tokens, af=tokens, df=tokens)
def test_request_lines_equal(kw, qf, af, df):
    jr = j_wire.Request(j_wire.RuntimeConfig(**kw), qf, af, df)
    tr = t_wire.Request(t_wire.RuntimeConfig(**kw), qf, af, df)
    assert tr.encode() == jr.encode()
    back = t_wire.Request.decode(jr.encode())
    assert (back.queryfile, back.answerfifo, back.difffile) == (qf, af, df)
    assert back.config == tr.config
    assert j_wire.Request.decode(tr.encode()).config == jr.config


def test_request_decode_rejects_short():
    with pytest.raises(ValueError, match="2 lines"):
        t_wire.Request.decode('{"itrs": 1}\n')


def _stats_kwargs():
    return st.fixed_dictionaries({
        "n_expanded": ints, "n_inserted": ints, "n_touched": ints,
        "n_updated": ints, "n_surplus": ints, "plen": ints,
        "finished": ints, "t_receive": floats, "t_astar": floats,
        "t_search": floats,
    })


@settings(max_examples=80, deadline=None)
@given(kw=_stats_kwargs())
def test_stats_row_lines_equal(kw):
    jr, tr = j_wire.StatsRow(**kw), t_wire.StatsRow(**kw)
    assert tr.encode() == jr.encode()
    assert tr.encode_wire() == jr.encode_wire()
    assert "," in tr.encode_wire() and tr.encode_wire() != "FAIL"
    back = t_wire.StatsRow.decode(jr.encode_wire())
    assert back.ok and dataclasses.asdict(back) == dataclasses.asdict(
        j_wire.StatsRow.decode(tr.encode_wire()))
    assert tr.as_list(1.5, 2.5, 7) == jr.as_list(1.5, 2.5, 7)


@pytest.mark.parametrize("row", [
    dict(ok=False), dict(ok=False, stale_epoch=True),
    dict(ok=False, stale_diff=True),
])
def test_stats_row_sentinels_equal(row):
    jr, tr = j_wire.StatsRow(**row), t_wire.StatsRow(**row)
    line = tr.encode_wire()
    assert line == jr.encode_wire()
    assert line in ("FAIL", "STALE_EPOCH", "STALE_DIFF")
    assert (dataclasses.asdict(t_wire.StatsRow.decode(line))
            == dataclasses.asdict(j_wire.StatsRow.decode(line)))
    assert not t_wire.StatsRow.decode(line).ok


@pytest.mark.parametrize("line", ["1,2,3", "", "a,b,c,d,e,f,g,h,i,j"])
def test_stats_row_bad_lines_raise_in_both(line):
    for wire in WIRE.values():
        with pytest.raises(ValueError):
            wire.StatsRow.decode(line)


@settings(max_examples=60, deadline=None)
@given(ok=st.booleans(), wid=st.integers(-1, 4096), pid=small,
       up=floats, b=small, bf=small, dr=small, err=text)
def test_health_status_lines_equal(ok, wid, pid, up, b, bf, dr, err):
    kw = dict(ok=ok, wid=wid, pid=pid, uptime_s=up, batches=b,
              batch_failures=bf, dropped=dr, last_error=err)
    jh, th = j_wire.HealthStatus(**kw), t_wire.HealthStatus(**kw)
    assert th.to_json() == jh.to_json()
    assert t_wire.HealthStatus.from_json(jh.to_json()) == th
    assert j_wire.HealthStatus.from_json(th.to_json()) == jh


@settings(max_examples=40, deadline=None)
@given(kw=_config_kwargs(), qf=tokens, af=tokens, df=tokens,
       fifo=tokens, wait=st.one_of(st.none(), st.floats(0.01, 900)))
def test_transfer_script_equal(kw, qf, af, df, fifo, wait):
    jr = j_wire.Request(j_wire.RuntimeConfig(**kw), qf, af, df)
    tr = t_wire.Request(t_wire.RuntimeConfig(**kw), qf, af, df)
    assert (t_fifo.make_script(tr, fifo, answer_wait_s=wait)
            == j_fifo.make_script(jr, fifo, answer_wait_s=wait))


@pytest.mark.parametrize("wait", [0.2, 1, 7.9, 30])
def test_ping_script_equal(wait):
    assert (t_fifo.ping_script("/tmp/w.fifo", "/nfs/answer.ping.x", wait)
            == j_fifo.ping_script("/tmp/w.fifo", "/nfs/answer.ping.x", wait))


@pytest.mark.parametrize("attempt", [0, 1, 4, 12])
def test_retry_backoff_equal(attempt, monkeypatch):
    monkeypatch.setenv("DOS_RETRY_MAX", "3")
    monkeypatch.setenv("DOS_RETRY_BASE_S", "0.05")
    jp, tp = j_fifo.RetryPolicy.from_env(), t_fifo.RetryPolicy.from_env()
    assert dataclasses.asdict(tp) == dataclasses.asdict(jp)
    assert (tp.backoff_s(attempt, seed="/nfs/answer.h3")
            == jp.backoff_s(attempt, seed="/nfs/answer.h3"))


def _files_equal(tmp_path, name, write_args, writer, reader):
    paths = {}
    for pkg, wire in WIRE.items():
        p = str(tmp_path / f"{pkg}-{name}")
        getattr(wire, writer)(p, *write_args)
        paths[pkg] = p
    with open(paths["jax"], "rb") as a, open(paths["torch"], "rb") as b:
        assert a.read() == b.read()
    got = getattr(t_wire, reader)(paths["jax"])
    want = getattr(j_wire, reader)(paths["torch"])
    if isinstance(got, tuple):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("q", [0, 1, 37])
def test_query_files_equal(tmp_path, q):
    queries = np.random.default_rng(q).integers(0, 10**6, (q, 2))
    _files_equal(tmp_path, "query", (queries,), "write_query_file",
                 "read_query_file")


@pytest.mark.parametrize("q,k", [(0, 3), (1, 1), (25, 8)])
def test_paths_files_equal(tmp_path, q, k):
    rng = np.random.default_rng(q + k)
    nodes = rng.integers(0, 5000, (q, k + 1))
    plen = rng.integers(0, k + 1, q)
    _files_equal(tmp_path, "q.paths", (nodes, plen), "write_paths_file",
                 "read_paths_file")
    assert t_wire.paths_file_for("/n/q") == j_wire.paths_file_for("/n/q")


@pytest.mark.parametrize("q", [0, 1, 40])
def test_results_files_equal(tmp_path, q):
    rng = np.random.default_rng(q)
    cost = rng.integers(0, 10**7, q)
    plen = rng.integers(0, 300, q)
    fin = rng.random(q) < 0.8
    _files_equal(tmp_path, "q.results", (cost, plen, fin),
                 "write_results_file", "read_results_file")
    assert (t_wire.results_file_for("/n/q")
            == j_wire.results_file_for("/n/q"))


def test_results_file_with_fingerprint_refused(tmp_path):
    """A fingerprinted results file (the ``answer_fp`` extension): the
    two packages write the same bytes and read each other's; a header
    whose ``fp=`` does not match the answers is refused by both with
    ``FingerprintError`` and books ``answer_fp_mismatch_total``."""
    from distributed_oracle_search_tpu.integrity import (
        fingerprint as j_fp)
    from distributed_oracle_search_tpu_torch.integrity import (
        fingerprint as t_fp)

    cost, plen, fin = np.array([5, 7]), np.array([2, 3]), np.array(
        [True, False])
    fp = t_fp.answer_fingerprint(cost, plen, fin)
    assert fp == j_fp.answer_fingerprint(cost, plen, fin)
    pj, pt = str(tmp_path / "j.results"), str(tmp_path / "t.results")
    j_wire.write_results_file(pj, cost, plen, fin, fp=fp)
    t_wire.write_results_file(pt, cost, plen, fin, fp=fp)
    with open(pj, "rb") as fj, open(pt, "rb") as ft:
        assert fj.read() == ft.read()
    for w, r in ((pj, t_wire), (pt, j_wire)):
        got = r.read_results_file(w)
        assert all((a == b).all() for a, b in zip(got, (cost, plen, fin)))
    bad = str(tmp_path / "bad.results")
    j_wire.write_results_file(bad, cost, plen, fin, fp=fp ^ 1)
    for r, mod in ((t_wire, t_fp), (j_wire, j_fp)):
        before = mod.M_FP_MISMATCH.value
        with pytest.raises(mod.FingerprintError, match="mismatch"):
            r.read_results_file(bad)
        assert mod.M_FP_MISMATCH.value == before + 1


@pytest.mark.parametrize("body,match", [
    ("", "empty"), ("3\n1 2 1\n", "header says"),
])
def test_bad_results_files_raise(tmp_path, body, match):
    p = str(tmp_path / "bad.results")
    with open(p, "w") as f:
        f.write(body)
    with pytest.raises(ValueError, match=match):
        t_wire.read_results_file(p)


def test_query_file_count_mismatch_raises(tmp_path):
    p = str(tmp_path / "q")
    with open(p, "w") as f:
        f.write("3\n1 2\n")
    with pytest.raises(ValueError, match="header says 3"):
        t_wire.read_query_file(p)
