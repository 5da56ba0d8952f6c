"""B7's tensor-core arithmetic on the CPU (`repro_torch.models.xlstm`).

The forward's kernels (`models/csrc/mlstm_chunk.cu`) form the products of
passes 1 and 3 on `wgmma` in bf16: every f32 operand cut into three bf16
pieces as it is staged into shared memory, each product the six piece
products a_i b_j (0-based i + j <= 2) of 16 rows of K at a time added to
one f32 accumulator — pass 1's dC = (a k)^T v, pass 3's S = q k^T, q C_in,
and P v added to the accumulator of scale_r (q C_in). The kernels cannot
run here, so their arithmetic is held in plain versions of it,
`mlstm_chunk_states_split_plain` and `mlstm_chunk_outputs_split_plain`,
composed with the plain inter-chunk scan (pass 2 is unchanged):

* against the JAX package's `mlstm_chunkwise` (parameters carried across
  with `params_from_jax`, inputs made with numpy from a seed) at chunks
  16, 40 and 64, D 16 and 192, with a carried state and at the extreme
  gates of tests/test_torch_xlstm_passes.py: every output and the final
  state within atol = rtol = 1e-5, the tolerance that file holds the plain
  passes to (stated before the first run);
* at the ill-conditioned recipe chip_smoke.py's `mlstm_f64_witness` uses
  (an input spike of 15, no direction shared by q and k, a carried state),
  seeds 41 and 42, against `mlstm_chunk_scan_plain` in f64: for h and the
  final C, n, m, the split's distance from the f64 result must be at most
  the plain f32 version's distance plus 1e-5 x max |f64| (stated before
  the first run);
* the row normaliser dot_r the outputs pass writes for B7-bwd, against the
  plain pass's at 1e-5 of its largest value."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import xlstm as jxlstm
from repro_torch.models import layers as tlayers
from repro_torch.models import xlstm as txlstm
from repro_torch.models.interop import params_from_jax
from test_torch_xlstm_passes import _inputs, _params

TOL = 1e-5
WITNESS_TOL = 1e-5

_j_chunkwise = jax.jit(jxlstm.mlstm_chunkwise, static_argnums=(2, 3),
                       static_argnames=("chunk",))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small CPU tensors: one intra-op thread each, so that the suite's
    parallel workers do not contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=TOL, rtol=TOL)


def _split_passes(q, k, v, it, ft, state, chunk, with_dot=False):
    """The three passes as the kernels compute them: the split states,
    the plain scan, the split outputs."""
    work, scal = txlstm.mlstm_chunk_states_split_plain(k, v, it, ft, chunk)
    state = txlstm.mlstm_state_scan_plain(work, scal, state)
    out = txlstm.mlstm_chunk_outputs_split_plain(q, k, v, it, ft, work, scal,
                                                 chunk, with_dot=with_dot)
    return out, state, work, scal


def _port(tp, x, H, D, chunk, state=None):
    B = x.shape[0]
    q, k, v, it, ft = txlstm._mlstm_qkv_gates(tp, x, H, D)
    state = txlstm._state_or_zeros(state, B, H, D, x.device)
    h, state, _, scal = _split_passes(q, k, v, it, ft, state, chunk)
    return tlayers.dense_apply(tp["wo"], h), state, scal


CASES = [  # (chunk, D, T, H, extreme, carried state)
    (16, 16, 96, 3, False, False), (40, 16, 200, 3, False, True),
    (64, 16, 256, 3, False, False), (64, 192, 192, 2, False, True),
    (40, 192, 120, 2, False, False), (16, 16, 192, 3, True, False),
    (40, 16, 240, 3, True, True), (64, 192, 384, 2, True, False)]


@pytest.mark.parametrize("chunk,D,T,H,extreme,carried", CASES)
def test_split_passes_match_jax(chunk, D, T, H, extreme, carried):
    B, d = 2, 48
    p = _params(80 + chunk + D, d, H, D, extreme=extreme)
    x = _inputs(81 + chunk + D, B, T, d, chunk=chunk if extreme else None)
    state_j = None
    if carried:   # the state the reference carries out of a first call
        _, state_j = _j_chunkwise(p, jnp.asarray(x), H, D, chunk=chunk)
        x = _inputs(82 + chunk + D, B, T, d,
                    chunk=chunk if extreme else None)
    ya, sa = _j_chunkwise(p, jnp.asarray(x), H, D, state=state_j,
                          chunk=chunk)
    state = None if state_j is None else \
        params_from_jax(jax.tree.map(np.asarray, state_j))
    yb, sb, scal = _port(params_from_jax(p), torch.from_numpy(x), H, D,
                         chunk, state=state)
    _close(yb, ya)
    for key in ("C", "n", "m"):
        _close(sb[key], sa[key])
    if extreme and D == 16:   # M_c = max(m, G_c) takes each side
        G, m_in = scal[:, :, 1:, 1], scal[:, :, 1:, 2]
        assert bool((G > m_in).any()) and bool((G < m_in).any())


def _witness_inputs(seed, B, H, T, D, chunk, spike=15.0):
    """chip_smoke.py's `mlstm_inputs(..., with_state=True, extreme=chunk,
    spike=15, shared_qk=False)` made with numpy, f64: q, k, v as (B, H, T,
    D) views of (B, T, H, D) (k scaled by 1/sqrt(D)), the gate recipe by
    chunk, a random carried state."""
    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape))
    q, k, v = (t(B, T, H, D).transpose(1, 2) for _ in range(3))
    it, fpre = t(B, T, H), t(B, T, H) + 1.0
    s = torch.arange(T)[None, :, None]
    c, mid = s // chunk, s % chunk == chunk // 2
    it = torch.where(mid & (c % 3 == 0), it + spike, it)
    it = torch.where(c % 3 == 1, it - 40.0, it)
    fpre = torch.where(mid & (c % 3 == 2), fpre - 8.0, fpre)
    ft = torch.nn.functional.logsigmoid(fpre).transpose(1, 2)
    state = {"C": t(B, H, D, D), "n": t(B, H, D), "m": t(B, H)}
    return q, k / D ** 0.5, v, it.transpose(1, 2), ft, state


@pytest.mark.parametrize("seed", [41, 42])
def test_split_is_as_near_f64_as_plain_f32(seed):
    B, H, T, D, chunk = 2, 2, 384, 192, 64
    raw = _witness_inputs(seed, B, H, T, D, chunk)
    keys = ("C", "n", "m")

    def outs(h_st):
        return [h_st[0], *(h_st[1][key] for key in keys)]
    ref = outs(txlstm.mlstm_chunk_scan_plain(*raw, chunk))
    f32 = [x.float() for x in raw[:5]]
    st32 = {key: x.float() for key, x in raw[5].items()}
    plain = outs(txlstm.mlstm_chunk_scan_plain(*f32, st32, chunk))
    h, s1, _, _ = _split_passes(*f32, st32, chunk)
    split = outs((h, s1))
    for name, a, p, r in zip(("h", *keys), split, plain, ref):
        assert a.dtype == torch.float32
        d_split = float((a.double() - r).abs().max())
        d_plain = float((p.double() - r).abs().max())
        assert d_split <= d_plain + WITNESS_TOL * float(r.abs().max()), \
            (name, d_split, d_plain)


@pytest.mark.parametrize("chunk,D", [(16, 16), (40, 192), (64, 192)])
def test_split_outputs_write_the_plain_normaliser(chunk, D):
    B, H, T = 2, 2, 3 * chunk
    q, k, v, it, ft, state = (x.float() if isinstance(x, torch.Tensor)
                              else {key: y.float() for key, y in x.items()}
                              for x in _witness_inputs(90 + chunk, B, H, T,
                                                       D, chunk, spike=6.0))
    (h, dot), _, work, scal = _split_passes(q, k, v, it, ft, state, chunk,
                                            with_dot=True)
    hp, dp = txlstm.mlstm_chunk_outputs_plain(q, k, v, it, ft, work, scal,
                                              chunk, with_dot=True)
    assert dot.shape == (B, H, T) and h.shape == (B, T, H * D)
    for got, want in ((h, hp), (dot, dp)):
        err = float((got - want).abs().max())
        assert err <= TOL * float(want.abs().max()), err


def _fma_counts(B, H, T, D, L):
    """B7's operations as `kernels.work.mlstm` counted them with every
    operation on the FMA units, before the products went to the tensor
    cores: {key: operations}."""
    n = B * H * (T // L)
    return {"whole": n * (2 * L * (L + 1) * D + 4 * L * D * D + 4 * L * D),
            "mlstm_chunk_states": n * (2 * L * D * D + 2 * L * D + 4 * L),
            "mlstm_state_scan": n * (3 * (D * D + D) + 6),
            "mlstm_chunk_outputs": n * (2 * L * L * D + L * (L + 1) * D
                                        + 2 * L * D * D + 2 * L * D + 8 * L)}


@pytest.mark.parametrize("B,H,T,D,L", [(1, 4, 32768, 192, 64),
                                       (4, 4, 4096, 192, 64),
                                       (2, 3, 200, 20, 40)])
def test_bound_keeps_the_operation_totals(B, H, T, D, L):
    """The restated bound moves the products to the TF32 peak and keeps
    every pass's total operations, so the dry run's per-kernel counts do
    not move; `.at("f32")` is the bound before the tensor cores."""
    from repro_torch.kernels import work
    ws = work.mlstm(B, H, T, D, L)
    for key, total in _fma_counts(B, H, T, D, L).items():
        w = ws[key]
        assert w.total_ops == total, key
        assert w.at("f32").bound() == work.Work({"f32": total},
                                                w.nbytes).bound(), key
        if key != "mlstm_state_scan":
            assert set(w.ops) == {"tf32", "f32"}, key
            assert w.bound()[0] <= w.at("f32").bound()[0], key
    if (B, T, D) == (1, 32768, 192):   # xlstm-125m's prefill: bytes bind
        assert ws["whole"].bound()[1] == "bytes"
        assert ws["mlstm_chunk_outputs"].bound()[1] == "bytes"
