"""B7 (the chunkwise mLSTM) as three passes, and the launch choices of B7's
and B8's CUDA wrappers (`repro_torch.models.xlstm`).

The three plain versions — `mlstm_chunk_states_plain` (each chunk's own
state contribution), `mlstm_state_scan_plain` (the serial scan over chunks,
in place) and `mlstm_chunk_outputs_plain` (each chunk's h from its incoming
state) — together compute the JAX package's `mlstm_chunkwise` chunk loop.
They are held against it here on the CPU: parameters made by the reference
and carried across with `params_from_jax`, inputs made with numpy from a
seed, at chunks 16, 40 and 64, with a carried state, and with extreme gates
that make a chunk's stabiliser M_c = max(m, G_c) take the carried m in some
chunks and the chunk's own G_c in others. The CUDA kernels are held against
these plain versions on the card by chip_smoke.py.

Tolerance: atol = rtol = 1e-5 on f32 outputs (the passes reassociate one
product of the reference's state update, exp(w_s - M_c) = exp(w_s - G_c)
exp(G_c - M_c), and sum in other orders; a few f32 roundings deep).

The wrappers' checks run on CPU tensors that say they live on a card (as
tests/test_torch_attention_route.py does), with the launch replaced by a
recorder where a test needs to reach it."""

import contextlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import xlstm as jxlstm
from repro_torch.models import layers as tlayers
from repro_torch.models import xlstm as txlstm
from repro_torch.models.interop import params_from_jax
from torch_parity import fake_cuda as _fake

TOL = 1e-5

_j_chunkwise = jax.jit(jxlstm.mlstm_chunkwise, static_argnums=(2, 3),
                       static_argnames=("chunk",))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want):
    np.testing.assert_allclose(_np(got), _np(want), atol=TOL, rtol=TOL)


def _params(seed, d, H, D, extreme=False):
    """The reference's mLSTM parameters (numpy). `extreme`: input feature 0
    drives i~ and feature 1 drives f~ (weight 1 for every head), and
    feature 2 adds to every column of q and k (weight 1)."""
    p = jax.tree.map(np.array, jxlstm.mlstm_init(jax.random.PRNGKey(seed), d,
                                                 H, D))
    if extreme:
        p["wi"]["w"][0, :] = 1.0
        p["wf"]["w"][1, :] = 1.0
        p["wq"]["w"][2, :] = 1.0
        p["wk"]["w"][2, :] = 1.0
    return p


def _inputs(seed, B, T, d, chunk=None):
    """x ~ N(0, 1). With `chunk` (the extreme case, with `_params(...,
    extreme=True)`), features 0-2 are set by chunk c: i~ + 6 on the middle
    step when c % 3 == 0 (an input spike), i~ - 40 on every step when
    c % 3 == 1 (the input gate shut: M_c keeps the carried m), the forget
    pre-activation - 8 on the middle step when c % 3 == 2 (f~ near -8:
    M_c = G_c); and feature 2 = 2 throughout, a direction shared by q and
    k, so that the normaliser |n . q| stays well away from zero (without
    it the spikes leave rows whose f32 result, in any summation order, is
    good to only ~1e-4 of the largest output)."""
    x = np.random.default_rng(seed).standard_normal((B, T, d)) \
        .astype(np.float32)
    if chunk:
        t = np.arange(T)
        c = t // chunk
        mid = t % chunk == chunk // 2
        x[:, :, :3] = 0.0
        x[:, mid & (c % 3 == 0), 0] = 6.0
        x[:, c % 3 == 1, 0] = -40.0
        x[:, mid & (c % 3 == 2), 1] = -8.0
        x[:, :, 2] = 2.0
    return x


def _passes(tp, x, H, D, chunk, state=None):
    """The port's mLSTM through the three plain passes: (y, state, scal)."""
    B = x.shape[0]
    q, k, v, it, ft = txlstm._mlstm_qkv_gates(tp, x, H, D)
    state = txlstm._state_or_zeros(state, B, H, D, x.device)
    work, scal = txlstm.mlstm_chunk_states_plain(k, v, it, ft, chunk)
    state = txlstm.mlstm_state_scan_plain(work, scal, state)
    h = txlstm.mlstm_chunk_outputs_plain(q, k, v, it, ft, work, scal, chunk)
    return tlayers.dense_apply(tp["wo"], h), state, scal


@pytest.mark.parametrize("chunk,D,T", [(16, 16, 256), (40, 24, 240),
                                       (64, 32, 256)])
def test_composed_passes_match_jax(chunk, D, T):
    B, H, d = 2, 3, 48
    p = _params(40 + chunk, d, H, D)
    x = _inputs(41 + chunk, B, T, d)
    ya, sa = _j_chunkwise(p, jnp.asarray(x), H, D, chunk=chunk)
    yb, sb, _ = _passes(params_from_jax(p), torch.from_numpy(x), H, D, chunk)
    _close(yb, ya)
    for key in ("C", "n", "m"):
        _close(sb[key], sa[key])


@pytest.mark.parametrize("chunk,D,T", [(16, 16, 256), (40, 24, 240),
                                       (64, 32, 256)])
def test_composed_passes_match_jax_at_extreme_gates(chunk, D, T):
    B, H, d = 2, 3, 48
    p = _params(50 + chunk, d, H, D, extreme=True)
    x = _inputs(51 + chunk, B, T, d, chunk=chunk)
    ya, sa = _j_chunkwise(p, jnp.asarray(x), H, D, chunk=chunk)
    yb, sb, scal = _passes(params_from_jax(p), torch.from_numpy(x), H, D,
                           chunk)
    _close(yb, ya)
    for key in ("C", "n", "m"):
        _close(sb[key], sa[key])
    # M_c = max(m, G_c) takes each side in some chunk past the first.
    G, m_in = scal[:, :, 1:, 1], scal[:, :, 1:, 2]
    assert bool((G > m_in).any()) and bool((G < m_in).any())


def test_composed_passes_match_jax_with_a_carried_state():
    """The state the reference carries out of a first call goes into both
    packages' second call."""
    B, H, D, d, chunk = 2, 3, 24, 48, 40
    p = _params(60, d, H, D)
    x = _inputs(61, B, 240, d)
    _, s1 = _j_chunkwise(p, jnp.asarray(x[:, :120]), H, D, chunk=chunk)
    ya, sa = _j_chunkwise(p, jnp.asarray(x[:, 120:]), H, D, state=s1,
                          chunk=chunk)
    state = params_from_jax(jax.tree.map(np.asarray, s1))
    assert float(state["m"].abs().max()) > 0.0
    yb, sb, _ = _passes(params_from_jax(p), torch.from_numpy(x[:, 120:]), H,
                        D, chunk, state=state)
    _close(yb, ya)
    for key in ("C", "n", "m"):
        _close(sb[key], sa[key])


def _raw(seed, B, H, T, D, state=True):
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(B, T, H, D, generator=g).transpose(1, 2)
               for _ in range(3))
    it = torch.randn(B, T, H, generator=g).transpose(1, 2)
    ft = torch.nn.functional.logsigmoid(
        torch.randn(B, T, H, generator=g) + 1.0).transpose(1, 2)
    st = txlstm.mlstm_state_init(B, H, D)
    if state:
        st = {"C": torch.randn(B, H, D, D, generator=g),
              "n": torch.randn(B, H, D, generator=g),
              "m": torch.randn(B, H, generator=g)}
    return q, k / D ** 0.5, v, it, ft, st


@pytest.mark.parametrize("chunk", [1, 7, 16])
def test_passes_compute_the_chunk_scans_function(chunk):
    """The passes against `mlstm_chunk_scan_plain` (the reference's chunk
    step in einsums), state included; pass 2 leaves each chunk's incoming
    state in the scratch, zero past column D."""
    B, H, T, D = 2, 2, 112, 20
    q, k, v, it, ft, st = _raw(70 + chunk, B, H, T, D)
    h0, s0 = txlstm.mlstm_chunk_scan_plain(q, k, v, it, ft, st, chunk)
    work, scal = txlstm.mlstm_chunk_states_plain(k, v, it, ft, chunk)
    assert tuple(work.shape) == (B, H, T // chunk, D + 1, 64)
    assert float(work[..., D:].abs().max()) == 0.0
    s1 = txlstm.mlstm_state_scan_plain(work, scal, st)
    np.testing.assert_array_equal(_np(work[:, :, 0, :D, :D]), _np(st["C"]))
    np.testing.assert_array_equal(_np(work[:, :, 0, D, :D]), _np(st["n"]))
    np.testing.assert_array_equal(_np(scal[:, :, 0, 2]), _np(st["m"]))
    np.testing.assert_array_equal(_np(scal[:, :, 1:, 2]),
                                  _np(scal[:, :, :-1, 0] + torch.maximum(
                                      scal[:, :, :-1, 2],
                                      scal[:, :, :-1, 1])))
    h1 = txlstm.mlstm_chunk_outputs_plain(q, k, v, it, ft, work, scal, chunk)
    _close(h1, h0)
    for key in ("C", "n", "m"):
        _close(s1[key], s0[key])


def test_scratch_sizes():
    assert [txlstm.mlstm_work_cols(D) for D in (1, 16, 64, 65, 192, 256)] \
        == [64, 64, 64, 128, 192, 256]
    assert txlstm.mlstm_work_shapes(1, 4, 32768, 192, 64) == (
        (1, 4, 512, 193, 192), (1, 4, 512, 4))
    # xlstm-125m's 32,768-token prefill: 303.6 MB of per-chunk states.
    assert txlstm.mlstm_work_bytes(1, 4, 32768, 192, 64) == 303_595_520
    assert txlstm.mlstm_work_bytes(2, 3, 48, 16, 16) == 4 * 2 * 3 * 3 * (
        17 * 64 + 4)


def test_slstm_cluster_choice():
    """The fewest blocks that keep <= 32 units (one lane each) a block."""
    assert [txlstm.slstm_cluster(Dh) for Dh in (1, 20, 32, 33, 192, 256)] \
        == [1, 1, 1, 2, 6, 8]
    assert txlstm.SLSTM_MAX_HEAD_DIM == 256
    # Every head size the wrapper takes fits a portable cluster (<= 8).
    assert txlstm.slstm_cluster(txlstm.SLSTM_MAX_HEAD_DIM) == 8


def _slstm_args(B=1, T=3, H=2, Dh=8, dtype=torch.float32,
                rdtype=torch.float32):
    wx = {g: _fake(torch.zeros(B, T, H * Dh, dtype=dtype)) for g in "zifo"}
    r = {g: _fake(torch.zeros(H, Dh, Dh, dtype=rdtype)) for g in "zifo"}
    st = {key: _fake(val) for key, val in
          txlstm.slstm_state_init(B, H, Dh).items()}
    return wx, r, st


def _r_of_another_shape(wx, r, st):
    r["z"] = _fake(torch.zeros(r["z"].shape[0], 8, 9))


def _state_of_another_shape(wx, r, st):
    st["c"] = _fake(torch.zeros(1, 2, 9))


@pytest.mark.parametrize("case,kw,edit,match", [
    ("float16 wx", {"dtype": torch.float16}, None, "one dtype"),
    ("float16 r", {"rdtype": torch.float16}, None, "one dtype"),
    ("Dh past 256", {"Dh": 257, "H": 1, "T": 1}, None, "head size 257"),
    ("r of another shape", {}, _r_of_another_shape, "wx must be"),
    ("state of another shape", {}, _state_of_another_shape,
     "state tensors must be"),
    ("too many clusters", {"B": 65536, "H": 1, "T": 1, "Dh": 2}, None,
     "65,535"),
])
def test_slstm_wrapper_raises_on_what_it_does_not_take(case, kw, edit,
                                                        match):
    wx, r, st = _slstm_args(**kw)
    if edit:
        edit(wx, r, st)
    with pytest.raises(ValueError, match=match):
        txlstm.slstm_scan_cuda(wx, r, st)


@pytest.mark.parametrize("option", ["cluster", "fast"])
def test_slstm_wrapper_takes_no_launch_options(option):
    """The cluster size and the cell's functions are fixed by the kernel's
    note, not chosen by the caller."""
    wx, r, st = _slstm_args()
    with pytest.raises(TypeError, match=option):
        txlstm.slstm_scan_cuda(wx, r, st, **{option: 1})


def _mlstm_args(B=1, H=2, T=32, D=16, dtype=torch.float32):
    qkv = [_fake(torch.zeros(B, T, H, D, dtype=dtype).transpose(1, 2))
           for _ in range(3)]
    it, ft = (_fake(torch.zeros(B, T, H).transpose(1, 2)) for _ in range(2))
    st = {key: _fake(val) for key, val in
          txlstm.mlstm_state_init(B, H, D).items()}
    return (*qkv, it, ft, st)


@pytest.mark.parametrize("case,kw,chunk,match", [
    ("chunk past 64", {"T": 130}, 65, "chunk=65"),
    ("chunk not dividing T", {"T": 40}, 16, "divide T=40"),
    ("D past 256", {"D": 257, "T": 16}, 16, "head size 257"),
    ("float64", {"dtype": torch.float64}, 16, "float32"),
])
@pytest.mark.parametrize("wrapper", ["states", "outputs", "whole"])
def test_mlstm_wrappers_raise_on_what_they_do_not_take(case, kw, chunk,
                                                       match, wrapper):
    q, k, v, it, ft, st = _mlstm_args(**kw)
    with pytest.raises(ValueError, match=match):
        if wrapper == "states":
            txlstm.mlstm_chunk_states_cuda(k, v, it, ft, chunk)
        elif wrapper == "outputs":
            work, scal = (_fake(torch.zeros(s)) for s in
                          txlstm.mlstm_work_shapes(1, 2, 32, 16, 16))
            txlstm.mlstm_chunk_outputs_cuda(q, k, v, it, ft, work, scal,
                                            chunk)
        else:
            txlstm.mlstm_chunk_scan_cuda(q, k, v, it, ft, st, chunk)


def test_mlstm_passes_refuse_a_cpu_scratch_or_a_wrong_one():
    q, k, v, it, ft, st = _mlstm_args()
    shapes = txlstm.mlstm_work_shapes(1, 2, 32, 16, 16)
    work, scal = (torch.zeros(s) for s in shapes)
    with pytest.raises(ValueError, match="CUDA tensors"):
        txlstm.mlstm_state_scan_cuda(work, scal, st)
    wrong = _fake(torch.zeros(1, 2, 2, 17, 32))
    with pytest.raises(ValueError, match="work / scal"):
        txlstm.mlstm_chunk_outputs_cuda(q, k, v, it, ft, wrong,
                                        _fake(torch.zeros(shapes[1])), 16)


@pytest.fixture
def launches(monkeypatch):
    """The kernels' C entry points replaced by recorders, and the card's
    device context and stream by stand-ins; device checks pass CPU
    tensors (the scratch the wrappers allocate lies where the inputs do)."""
    calls = []

    def fn_of(lib):
        def get(name, *_):
            def record(*args):
                calls.append((lib, name, args))
                return 0
            return record
        return get

    monkeypatch.setattr(txlstm, "_mlstm_fn", fn_of("mlstm_chunk"))
    monkeypatch.setattr(txlstm, "_slstm_fn", fn_of("slstm"))
    monkeypatch.setattr(txlstm, "_check_cuda", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=7))
    return calls


@pytest.mark.parametrize("Dh,want", [(192, 6), (33, 2), (20, 1), (256, 8)])
def test_slstm_wrapper_launch_shape(launches, Dh, want):
    B, T, H = 2, 5, 2
    wx, r, st = _slstm_args(B=B, T=T, H=H, Dh=Dh, dtype=torch.bfloat16)
    before = txlstm.slstm_scan_cuda.launches
    h, out = txlstm.slstm_scan_cuda(wx, r, st)
    assert txlstm.slstm_scan_cuda.launches == before + 1
    assert h.shape == (B, T, H * Dh) and h.dtype == torch.float32
    assert all(out[key].shape == (B, H, Dh) for key in "hcnm")
    ((lib, name, args),) = launches
    assert (lib, name) == ("slstm", "slstm")
    # No record (a null pointer), then B, T, H, Dh, dtype code (bf16 wx,
    # f32 r: 2), cluster, stream.
    assert args[17:] == (0, B, T, H, Dh, 2, want, 7)


def test_mlstm_whole_launches_the_three_passes_on_one_scratch(launches):
    B, H, T, D, chunk = 2, 3, 48, 20, 16
    q, k, v, it, ft, st = _raw(80, B, H, T, D)
    before = [fn.launches for fn in (txlstm.mlstm_chunk_states_cuda,
                                     txlstm.mlstm_state_scan_cuda,
                                     txlstm.mlstm_chunk_outputs_cuda)]
    h, state = txlstm.mlstm_chunk_scan_cuda(q, k, v, it, ft, st, chunk)
    assert [fn.launches for fn in (txlstm.mlstm_chunk_states_cuda,
                                   txlstm.mlstm_state_scan_cuda,
                                   txlstm.mlstm_chunk_outputs_cuda)] \
        == [n + 1 for n in before]
    assert h.shape == (B, T, H * D)
    assert state["C"].shape == (B, H, D, D) and state["m"].shape == (B, H)
    names = [name for _, name, _ in launches]
    assert names == ["mlstm_chunk_states_launch", "mlstm_state_scan_launch",
                     "mlstm_chunk_outputs_launch"]
    states, scan, outputs = (args for _, _, args in launches)
    # One scratch (work, scal) from pass 1 through pass 3, which is not
    # asked for the rows' normalisers (a null pointer).
    assert states[4:6] == scan[0:2] == outputs[5:7]
    assert outputs[8] == 0
    assert states[6:11] == (B, H, T, D, chunk)
    assert scan[8:12] == (B, H, T // chunk, D)
    # q, k, v strides (b, h, t) of the (B, T, H, D) views, then the gates'.
    assert outputs[14:20] == (T * H * D, D, H * D, T * H, 1, H)


@pytest.mark.parametrize("kernel", ["slstm", "mlstm_chunk_outputs"])
def test_the_record_for_the_backward_is_written_only_when_asked(launches,
                                                                kernel):
    """One entry point per kernel: the record B8-bwd / B7-bwd reads (sLSTM's
    per-step record, each mLSTM row's normaliser) is a pointer to the
    returned tensor when asked and a null pointer otherwise."""
    for asked in (False, True):
        launches.clear()
        if kernel == "slstm":
            out = txlstm.slstm_scan_cuda(*_slstm_args(B=2, T=5, Dh=8),
                                         with_saved=asked)
            at = 17
        else:
            q, k, v, it, ft, _ = _raw(81, 1, 2, 32, 16)
            work, scal = (torch.zeros(s_) for s_ in
                          txlstm.mlstm_work_shapes(1, 2, 32, 16, 16))
            out = txlstm.mlstm_chunk_outputs_cuda(q, k, v, it, ft, work,
                                                  scal, 16, with_dot=asked)
            at = 8
        ((_, name, args),) = launches
        assert name == {"slstm": "slstm"}.get(kernel, f"{kernel}_launch")
        if asked:
            assert args[at] == out[-1].data_ptr() != 0
        else:
            assert args[at] == 0
