"""The language-model kernels' CUDA wrappers where autograd would record
them. Five have a backward: B5's two routes (`flash_attention_tc_cuda`,
B5-bwd; `flash_attention_tf32x3_cuda`, the split-TF32 backward), B6
(`rglru_scan_cuda`, B6-bwd), B7 whole (`mlstm_chunk_scan_cuda`, B7-bwd)
and B8 (`slstm_scan_cuda`, B8-bwd). There each goes through its autograd
Function (`FlashAttention`, `RGLRUScan`, `MLSTMChunkScan`, `SLSTMScan`),
records a backward, reaches its forward's entry points (asked to keep
what the backward reads: the log-sum-exp, B6's scratch, each row's mLSTM
normaliser, sLSTM's per-step record) and, on `.backward()`, the
backward's. The others refuse: B5's FMA kernel, on no route
(`flash_attention_fma_cuda`), and B7's three passes launched on their
own (`mlstm_chunk_{states,outputs}_cuda`, `mlstm_state_scan_cuda`). None
of these has a backward, so an output computed from an input that
requires grad would silently carry no gradient; each wrapper raises
instead, naming itself, and launches nothing. Under `torch.no_grad()`, or
when no input requires grad, every call gets past the check and reaches
its serving launch.

The inputs are CPU tensors that say they live on a card (`fake_cuda`),
with every kernel entry point replaced by a recorder and the card's
device context and stream by stand-ins."""

import contextlib
import types

import pytest
import torch

from repro_torch.kernels.local_attention import local_attention as la
from repro_torch.models import rglru as trglru
from repro_torch.models import xlstm as txlstm
from torch_parity import fake_cuda


@pytest.fixture
def launches(monkeypatch):
    """Kernel entry points replaced by recorders of their names; xlstm's
    device check sees the scratch its wrappers allocate (CPU tensors
    here, where the inputs lie) as card tensors, its grad check intact."""
    calls = []

    def recorder(name):
        def record(*args):
            calls.append(name)
            return 0
        return record

    monkeypatch.setattr(la, "_lib", lambda lib, fn, *n, **kw: recorder(fn))
    monkeypatch.setattr(trglru, "_lib", lambda name="rglru_scan": (
        recorder(f"{name}_launch"), lambda B, T, D: 16))
    monkeypatch.setattr(txlstm, "_mlstm_fn",
                        lambda name, nargs, lib=None: recorder(name))
    monkeypatch.setattr(txlstm, "_slstm_fn",
                        lambda name, nints: recorder(name))
    check = txlstm._check_cuda
    monkeypatch.setattr(txlstm, "_check_cuda", lambda name, *ts: check(
        name, *(fake_cuda(t) for t in ts)))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=7))
    return calls


def _z(*shape, dtype=torch.float32, grad=False):
    t = torch.zeros(shape, dtype=dtype)
    if grad:
        t.requires_grad_()
    return fake_cuda(t)


def _flash(fn, dtype, D):
    def call(grad):
        q = _z(1, 2, 16, D, dtype=dtype, grad=grad)
        return fn(q, _z(1, 1, 16, D, dtype=dtype), _z(1, 1, 16, D, dtype=dtype),
                  window=8)
    return call


def _rglru(grad):
    B, T, D = 2, 5, 16
    wa = _z(B, T, D, grad=grad)
    return trglru.rglru_scan_cuda(wa, _z(B, T, D), _z(B, T, D), _z(D),
                                  _z(B, D))


B, H, T, D, CHUNK = 1, 2, 32, 16, 16


def _qkv_gates(grad):
    q, k, v = (_z(B, T, H, D, grad=grad and i == 1).transpose(1, 2)
               for i in range(3))
    it, ft = (_z(B, T, H).transpose(1, 2) for _ in range(2))
    return q, k, v, it, ft


def _work():
    return [_z(*s) for s in txlstm.mlstm_work_shapes(B, H, T, D, CHUNK)]


def _states(grad):
    _, k, v, it, ft = _qkv_gates(grad)
    return txlstm.mlstm_chunk_states_cuda(k, v, it, ft, CHUNK)


def _scan(grad):
    state = {key: _z(*val.shape, grad=grad and key == "C")
             for key, val in txlstm.mlstm_state_init(B, H, D).items()}
    return txlstm.mlstm_state_scan_cuda(*_work(), state)


def _outputs(grad):
    return txlstm.mlstm_chunk_outputs_cuda(*_qkv_gates(grad), *_work(),
                                           CHUNK)


def _whole(grad):
    state = {key: fake_cuda(val)
             for key, val in txlstm.mlstm_state_init(B, H, D).items()}
    return txlstm.mlstm_chunk_scan_cuda(*_qkv_gates(grad), state, CHUNK)


def _slstm(grad):
    Bs, Ts, Hs, Dh = 2, 3, 2, 8
    wx = {g: _z(Bs, Ts, Hs * Dh, grad=grad and g == "f") for g in "zifo"}
    r = {g: _z(Hs, Dh, Dh) for g in "zifo"}
    state = {key: fake_cuda(val)
             for key, val in txlstm.slstm_state_init(Bs, Hs, Dh).items()}
    return txlstm.slstm_scan_cuda(wx, r, state)


#: wrapper name -> (call(grad): the wrapper on small inputs, one of them
#: requiring grad when `grad`; the launches it makes).
WRAPPERS = {
    "flash_attention_tc_cuda": (
        _flash(la.flash_attention_tc_cuda, torch.bfloat16, 64),
        ["flash_attention_tc_launch"]),
    "flash_attention_tf32x3_cuda": (
        _flash(la.flash_attention_tf32x3_cuda, torch.float32, 16),
        ["flash_attention_tf32x3_launch"]),
    "flash_attention_fma_cuda": (
        _flash(la.flash_attention_fma_cuda, torch.float32, 16),
        ["flash_attention_launch"]),
    "rglru_scan_cuda": (_rglru, ["rglru_scan_launch"]),
    "mlstm_chunk_states_cuda": (_states, ["mlstm_chunk_states_launch"]),
    "mlstm_state_scan_cuda": (_scan, ["mlstm_state_scan_launch"]),
    "mlstm_chunk_outputs_cuda": (_outputs, ["mlstm_chunk_outputs_launch"]),
    "mlstm_chunk_scan_cuda": (_whole, ["mlstm_chunk_states_launch",
                                       "mlstm_state_scan_launch",
                                       "mlstm_chunk_outputs_launch"]),
    "slstm_scan_cuda": (_slstm, ["slstm"]),
}


#: Wrappers with a backward: the autograd Function a call under autograd
#: records, the launches it makes, and those its `.backward()` adds.
HAS_BACKWARD = {
    "flash_attention_tc_cuda": (
        "FlashAttention", ["flash_attention_tc_launch"],
        ["flash_attention_bwd_tc_launch"]),
    "flash_attention_tf32x3_cuda": (
        "FlashAttention", ["flash_attention_tf32x3_launch"],
        ["flash_attention_bwd_tf32x3_launch"]),
    "rglru_scan_cuda": ("RGLRUScan", ["rglru_scan_launch"],
                        ["rglru_scan_bwd_launch"]),
    "mlstm_chunk_scan_cuda": (
        "MLSTMChunkScan", ["mlstm_chunk_states_launch",
                           "mlstm_state_scan_launch",
                           "mlstm_chunk_outputs_launch"],
        ["mlstm_bwd_outputs_launch", "mlstm_bwd_scan_launch",
         "mlstm_bwd_inputs_launch"]),
    "slstm_scan_cuda": ("SLSTMScan", ["slstm"], ["slstm_bwd"]),
}


@pytest.mark.parametrize("name", list(WRAPPERS))
def test_wrapper_raises_on_an_input_that_requires_grad(launches, name):
    """Each wrapper without a backward raises; B5's two routes, B6, B7
    whole and B8 record a backward instead and reach both sets of entry
    points."""
    call, _ = WRAPPERS[name]
    assert torch.is_grad_enabled()
    if name in HAS_BACKWARD:
        fn, fwd, bwd = HAS_BACKWARD[name]
        out = call(True)
        if isinstance(out, tuple):
            out = out[0]
        assert out.requires_grad
        assert type(out.grad_fn).__name__ == f"{fn}Backward"
        assert launches == fwd
        out.backward(torch.ones_like(out))
        assert launches == fwd + bwd
        return
    with pytest.raises(RuntimeError, match=f"{name}: .*no backward"):
        call(True)
    assert launches == []


@pytest.mark.parametrize("mode", ["no_grad", "no_input_requires_grad"])
@pytest.mark.parametrize("name", list(WRAPPERS))
def test_wrapper_gets_past_the_guard(launches, name, mode):
    call, want = WRAPPERS[name]
    if mode == "no_grad":
        with torch.no_grad():
            call(True)
    else:
        call(False)
    assert launches == want
