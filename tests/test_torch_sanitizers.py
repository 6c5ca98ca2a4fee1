"""The port's runtime sanitizers (``repro_torch/analysis/sanitizers.py``) on
the CPU: the recompile census and budget, and the transfer guard's
contract, which on the card is ``torch.cuda.set_sync_debug_mode``.

PyTorch without CUDA raises on ``set_sync_debug_mode``, so the guard's
use of it is checked with the function replaced by a recorder, and the
executor taken for one on the card (``on_card``, which the guard and the
executor's explicit window of ``core/streams.py`` both ask). The
recorder checks that the engine enters "error" around each in-flight pump
and drain, that every boundary copy (``to_device`` / ``host`` of
``core/streams.py``) runs in the explicit window (mode 0), and that the
mode found on entry comes back on every exit, a stage's exception
included. On the card ``chip_smoke.py`` phase 13c holds the real guard
(a deliberate ``.item()`` inside it must raise).
"""
import numpy as np
import pytest
import torch

from repro_torch import engine as te
from repro_torch.analysis import sanitizers
from repro_torch.analysis.sanitizers import (RecompileBudgetError,
                                             RecompileSanitizer,
                                             jit_roots, named_jit_roots,
                                             transfer_guard_ctx)
from repro_torch.core import streams
from repro_torch.kernels import _build

from test_torch_engine import _packets, system  # noqa: F401

torch.set_num_threads(1)


def _serve(system, engine, which, t0=0.0, pumps=0):
    futs = [engine.submit_packet(p, q, it, time_s=t0 + i)
            for i, (p, q, it) in enumerate(_packets(system, "t", which))]
    for _ in range(pumps):
        engine.pump()
    engine.drain()
    assert all(f.result().failure is None for f in futs)
    return futs


def test_census_is_empty_on_the_cpu(system):
    engine = te.AveryEngine(lut=system["tex"].lut, executor=system["tex"],
                            batching="inflight", max_batch=4,
                            debug_recompiles=True)
    _serve(system, engine, range(4))
    assert named_jit_roots(engine) == {} and jit_roots(engine) == []
    assert engine.arm_sanitizers() == 0
    assert engine.stats["compiled_traces"] == 0
    assert engine.executor.num_compiled_stages == 0


def test_a_library_loaded_after_arming_breaks_the_budget(system, tmp_path,
                                                         monkeypatch):
    """Steady state loads a kernel library (one fake ``_loaded`` entry):
    ``check(budget=0)`` raises, budget 1 passes, and the engine's own
    pump raises after dumping its flight ring."""
    engine = te.AveryEngine(lut=system["tex"].lut, executor=system["tex"],
                            batching="inflight", max_batch=4,
                            debug_recompiles=True, flight_dir=str(tmp_path))
    _serve(system, engine, range(3))
    assert engine.arm_sanitizers() == 0
    san = engine._recompile_sanitizer
    assert isinstance(san, RecompileSanitizer)
    monkeypatch.setitem(_build._loaded, "fake_kernel", object())
    assert list(named_jit_roots(engine)) == ["kernels.fake_kernel"]
    assert san.new_compiles() == 1
    assert engine.stats["new_compiles_since_arm"] == 1
    with pytest.raises(RecompileBudgetError):
        san.check(budget=0)
    san.check(budget=1)
    engine.check_sanitizers(budget=1)
    dumps = engine.flight.n_dumps
    with pytest.raises(RecompileBudgetError):
        engine.pump()
    assert engine.flight.n_dumps == dumps + 1
    assert list(tmp_path.glob("flight_*_recompile_budget.json"))
    assert issubclass(RecompileBudgetError, AssertionError)


def test_sanitizer_off_and_unarmed(system):
    engine = te.AveryEngine(lut=system["tex"].lut, executor=system["tex"],
                            batching="inflight", max_batch=4)
    assert engine.arm_sanitizers() is None
    engine.check_sanitizers()
    stats = engine.stats
    assert "compiled_traces" not in stats
    assert "new_compiles_since_arm" not in stats


class _Recorder:
    """Stands in for ``torch.cuda.{get,set}_sync_debug_mode``: keeps the
    current mode and every mode set."""

    def __init__(self, mode=0):
        self.mode, self.sets = mode, []

    def get(self):
        return self.mode

    def set(self, mode):
        self.sets.append(mode)
        self.mode = mode


def _take_for_the_card(monkeypatch):
    for mod in (sanitizers, streams):
        monkeypatch.setattr(mod, "on_card", lambda device: True)


def _guarded_engine(system, **kw):
    return te.AveryEngine(lut=system["tex"].lut, executor=system["tex"],
                          batching="inflight", max_batch=4,
                          debug_transfers=True, **kw)


def test_guard_is_a_no_op_on_a_cpu_executor(system, monkeypatch):
    rec = _Recorder()
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", rec.set)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", rec.get)
    assert transfer_guard_ctx(True, "cpu") is streams.NULL_CTX
    assert transfer_guard_ctx(False, "cuda") is streams.NULL_CTX
    _serve(system, _guarded_engine(system), range(4), pumps=2)
    assert rec.sets == []


def test_guard_brackets_each_pump_and_drain(system, monkeypatch):
    """With the recorder in place of ``set_sync_debug_mode`` and the
    executor taken for a CUDA one: "error" around every pump and drain,
    the window (mode 0) around every boundary copy inside them, the
    previous mode back after each."""
    rec = _Recorder(mode="warn")          # a mode the guard must restore
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", rec.set)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", rec.get)
    _take_for_the_card(monkeypatch)
    copies = []
    real_cpu, real_as_tensor = torch.Tensor.cpu, torch.as_tensor

    def cpu(t, *a, **kw):                 # host()'s copy to the host
        copies.append(("host", rec.mode))
        return real_cpu(t, *a, **kw)

    def as_tensor(x, *a, **kw):           # to_device()'s copy to the device
        copies.append(("dev", rec.mode))
        return real_as_tensor(x, *a, **kw)

    monkeypatch.setattr(torch.Tensor, "cpu", cpu)
    monkeypatch.setattr(torch, "as_tensor", as_tensor)
    engine = _guarded_engine(system)
    futs = [engine.submit_packet(p, q, it, time_s=float(i))
            for i, (p, q, it) in enumerate(_packets(system, "t",
                                                    range(4)))]
    inside = []
    for _ in range(2):
        rec.sets.clear()
        copies.clear()
        engine.pump()
        assert rec.mode == "warn"
        inside.append((list(rec.sets), list(copies)))
    rec.sets.clear()
    copies.clear()
    engine.drain()
    inside.append((list(rec.sets), list(copies)))
    assert all(f.result().failure is None for f in futs)
    assert rec.mode == "warn"
    for sets, made in inside:
        assert sets[0] == "error" and sets[-1] == "warn"
        # every window is a (0, "error") pair inside the guard
        body = sets[1:-1]
        assert body == [0, "error"] * (len(body) // 2)
        assert made and all(mode == 0 for _, mode in made)
        assert {k for k, _ in made} == {"dev", "host"}


def test_guard_restores_the_mode_when_a_stage_raises(system, monkeypatch):
    rec = _Recorder(mode="warn")
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", rec.set)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", rec.get)
    _take_for_the_card(monkeypatch)

    class Broken:
        """The executor, but once ``broken`` its decode step dies with an
        error that no retry catches."""

        def __init__(self, inner):
            self._inner = inner
            self.broken = False

        def __getattr__(self, name):
            return getattr(self._inner, name)

        def cloud_decode_rows(self, *a):
            if not self.broken:
                return self._inner.cloud_decode_rows(*a)
            self._inner._dev(np.zeros(1))     # a window opens first
            raise RuntimeError("stage died")

    ex = Broken(system["tex"])
    engine = te.AveryEngine(lut=system["tex"].lut, executor=ex,
                            batching="inflight", max_batch=4,
                            debug_transfers=True)
    for i, (p, q, it) in enumerate(_packets(system, "t", range(2))):
        engine.submit_packet(p, q, it, time_s=float(i))
    ex.broken = True
    rec.sets.clear()
    with pytest.raises(RuntimeError, match="stage died"):
        engine.pump()
    assert rec.mode == "warn"
    assert rec.sets[0] == "error" and rec.sets[-1] == "warn"
    assert 0 in rec.sets


def test_sanitizer_smoke_runs_on_the_cpu(capsys):
    assert sanitizers.main(["--smoke", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "[sanitizers] smoke ok on cpu" in out
