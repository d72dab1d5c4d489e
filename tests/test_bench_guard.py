"""Failure guards in bench.py: a backend that fails to start, or an
accelerator that is missing, ends the run with a non-zero exit and no
metric; every metric printed is also persisted."""

import json
import os
import sys

import pytest

import bench


@pytest.fixture()
def bench_env(tmp_path, monkeypatch):
    # main() installs a tee over stderr; make pytest restore it
    monkeypatch.setattr(sys, "stderr", sys.stderr)
    monkeypatch.setattr(bench, "ROOT", str(tmp_path))
    monkeypatch.setattr(bench, "_JSON_PATHS",
                        [str(tmp_path / "result" / "bench_test.json")])
    monkeypatch.setattr(bench, "_LOG_PATH",
                        str(tmp_path / "result" / "bench_test.log"))
    (tmp_path / "result").mkdir()
    return tmp_path


def test_emit_obj_persists_and_prints(bench_env, capsys):
    bench._emit_obj({"metric": "render_fps_800x800", "value": 2.0,
                     "unit": "fps", "vs_baseline": 0.4})
    out = capsys.readouterr().out.strip()
    assert json.loads(out)["value"] == 2.0
    with open(bench._JSON_PATHS[0]) as f:
        assert json.loads(f.readline())["value"] == 2.0
    hist = bench_env / "result" / "bench_history.jsonl"
    assert json.loads(hist.read_text())["value"] == 2.0


def test_main_bails_on_backend_failure(bench_env, monkeypatch, capsys):
    monkeypatch.setattr(bench, "_probe_backend", lambda: None)
    with pytest.raises(SystemExit) as exc:
        bench.main()
    assert exc.value.code not in (0, None)
    assert capsys.readouterr().out == ""


def test_main_bails_on_implicit_cpu_fallback(bench_env, monkeypatch,
                                             capsys):
    """An accelerator that fails to start leaves JAX on the CPU with no
    trace in the environment — bench must not start a dense 800^2 gate
    render there, nor print a metric."""
    monkeypatch.setattr(bench, "_probe_backend", lambda: "cpu")
    monkeypatch.delenv("JAX_PLATFORMS", raising=False)
    with pytest.raises(SystemExit) as exc:
        bench.main()
    assert "cpu" in str(exc.value.code).lower()
    assert capsys.readouterr().out == ""


def test_main_allows_explicit_cpu(bench_env, monkeypatch):
    """JAX_PLATFORMS=cpu (a deliberate CPU rehearsal) still runs."""
    monkeypatch.setattr(bench, "_probe_backend", lambda: "cpu")
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    monkeypatch.setenv("BENCH_MODEL", "freq")
    ran = {}
    monkeypatch.setattr(bench, "run_freq",
                        lambda: ran.setdefault("freq", True))
    bench.main()
    assert ran.get("freq")


def test_tee_stderr_delegates_stream_api(bench_env):
    """Libraries probe isatty()/encoding/fileno on stderr (warnings,
    absl, tqdm); the tee must expose the full file API."""
    tee = bench._TeeStderr(str(bench_env / "result" / "tee.log"))
    assert tee.isatty() == sys.stderr.isatty()
    assert tee.encoding == sys.stderr.encoding
    tee.write("x")
    tee.flush()


def test_ladder_has_v2_intermediate_steps():
    """The freq_rm gate passed only at 32,14,12 because 32,10,10 missed
    the 0.2 dB budget by 0.12 dB; the default ladder must keep the
    cheaper intermediate steps in between."""
    src = open(os.path.join(os.path.dirname(bench.__file__),
                            "bench.py")).read()
    i = src.index('"BENCH_NGP_LADDER"')
    default = src[i:i + 200]
    assert "32,10,10" in default
    assert "32,12,10" in default and "32,12,12" in default
    assert "32,14,12" in default


def test_ladder_cache_keyed_by_ladder_string():
    """Inserting a new intermediate ladder step must invalidate the
    cached passing step, or the walk would resume at a coarser pass and
    never try the cheaper step."""
    src = open(os.path.join(os.path.dirname(bench.__file__),
                            "bench.py")).read()
    i = src.index('lad_cache = _cache_path(')
    call = src[i:i + 300]
    assert "ladder_env)" in call
