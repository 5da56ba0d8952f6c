#!/usr/bin/env python
"""Split the time of B7's outputs pass, of B7-bwd's inputs side and of
B6-bwd into parts, by variants of their sources with a part switched off,
in one run.

Usage: python tools/bwd_parts.py [--checkout DIR] [--reps N]

Reads ``models/csrc/mlstm_chunk.cu``, ``mlstm_chunk_bwd.cu`` and
``rglru_scan_bwd.cu`` of DIR (this repository by default; an older commit
unpacked with ``git archive`` into a .gitignore'd directory for its
designs), writes copies with preprocessor switches around each part into
DIR's ``build/parts/``, builds every variant with ``nvcc`` at once and
times each in place of the checkout's own kernel
(`kernel_timing.time_cuda`): B7's outputs pass at xlstm-125m's prefill
shape (1 x 4 heads x 32,768, D 192, chunk 64, f32; the serving launch),
B7-bwd's inputs side at its training shape (4 x 4 heads x 4,096), B6-bwd
at recurrentgemma-9b's training microbatch (2 x 4,096 x 4,096 bf16). A
variant computes wrong values; only its time is read. The switches know
B7's FMA design (every product a `tile_mma` call) and its wgmma design,
B7-bwd's staged design (every product a `gemm_staged` call) and its
tensor-core design, and both B6-bwd designs (8 warps of 12 steps, 16 of
6); a part a source does not have is left out. Prints one JSON line: per
kernel, ms by variant in two rounds, "full" being the unchanged source.
Exits 1 with no CUDA device. Imports no JAX.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

from kernel_timing import card, checkout_args, time_cuda


def guard(s, start, end, macro):
    """s with [start, end) wrapped in `#ifndef macro`; None when either
    marker is missing."""
    i = s.find(start)
    j = s.find(end, i + 1) if i >= 0 else -1
    if i < 0 or j < 0:
        return None
    return s[:i] + f"#ifndef {macro}\n" + s[i:j] + "#endif\n" + s[j:]


def wrap(s, snippet, macro, alt=""):
    """s with `snippet` (whole lines) under `#ifndef macro`, `alt` in its
    place when the macro is set; s unchanged when the snippet is missing."""
    if snippet not in s:
        return s
    return s.replace(snippet, f"#ifndef {macro}\n{snippet}#else\n{alt}"
                     "#endif\n", 1)


def b7_fwd_fma(s):
    """B7's outputs pass on the FMA units: q k^T, q C_in with its cp.async
    stream of C, P v (each a `tile_mma` call), the gate scans and the
    stores (kept as a compare, so that the products stay live)."""
    s = wrap(s, "    tile_mma<1>(acc, qT, LP, kT, LP, 0, D, r0, 4 * tc);\n",
             "NO_QK")
    a = s.index("  load_slice(0);\n")
    b = s.index("  // h~ = scale_r (q C) + P v;")
    s = s[:a] + "#ifndef NO_QC\n" + s[a:b] + "#endif\n" + s[b:]
    s = wrap(s, "  tile_mma<NJ>(acc, PT, LP, vs, DP, 0, min(L, 8 * warp + 8),"
             " r0, 4 * tc);\n", "NO_PV")
    a = s.index("    const GateScan r = gate_scan(iv, fv, L, lane);\n"
                "#pragma unroll\n    for (int u = 0; u < 2; ++u) {")
    b = s.index("  } else {\n    for (int r = warp - 1;", a)
    s = s[:a] + "#ifndef NO_GATES\n" + s[a:b] + "#endif\n" + s[b:]
    s = wrap(s, "        if (col < D) out[col] = acc[i][4 * j + jj] / den;\n",
             "NO_STORES", "        if (col < D && acc[i][4 * j + jj] == "
             "12345.0f) out[col] = den;\n")
    return s, {"no_qk": "NO_QK", "no_qc": "NO_QC", "no_pv": "NO_PV",
               "no_gates": "NO_GATES", "no_stores": "NO_STORES",
               "no_products": "NO_QK NO_QC NO_PV"}


def b7_fwd_wgmma(s):
    """B7's outputs pass on wgmma: the q k^T, q C_in and P v batches, the
    producer's loads of C_in and v and the staging loads of q and k (other
    values in their place), the gate scans and the stores (kept as a
    compare)."""
    s = wrap(s, "      wgmma_sst<64, 0, 0>(sacc, desc_k(s_q + piece_a(t) * "
             "C::OP, LMAX, kk),\n                          desc_k(s_k + "
             "piece_b(t) * C::OP, LMAX, kk));\n", "NO_QK")
    s = wrap(s, "      wgmma_sst<DP, 0, 1>(\n          acc, desc_k(s_q + "
             "piece_a(t) * C::OP, LMAX, sl),\n          desc_mn(s_ring + "
             "(sg * NP + piece_b(t)) * C::SL, KS, 0));\n", "NO_QC")
    s = wrap(s, "      wgmma_rs<DP>(acc, pa[kq][piece_a(t)],\n"
             "                   desc_mn(s_ring + (sg * NP + piece_b(t)) * "
             "C::SL, KS, 0));\n", "NO_PV")
    s = wrap(s, "        if (i < NC) {\n          const int d = i * KS + "
             "row[f];\n          if (d < D)\n            x[f] = *reinterpret"
             "_cast<const float4*>(slot + (int64_t)d * DP\n"
             "                                                    + col[f]);"
             "\n        } else {\n          const int s = (i - NC) * KS + "
             "row[f];\n          if (s < L)\n            x[f] = ld4(v + off "
             "+ (int64_t)s * st.qs_t, col[f], D, vec);\n        }\n",
             "NO_STREAM", "        x[f] = make_float4(i, row[f], col[f], "
             "0.f);\n")
    s = wrap(s, "          x[i][u] = r < L && col < DP\n"
             "                        ? ld4(src + off + (int64_t)r * st.qs_t, "
             "col, D, vec)\n                        : make_float4(0.f, 0.f, "
             "0.f, 0.f);\n", "NO_STAGE",
             "          x[i][u] = make_float4(r, col, 0.f, 0.f);\n")
    s = wrap(s, "    const GateScan r = gate_scan(iv, fv, L, lane);\n"
             "#pragma unroll\n    for (int u = 0; u < 2; ++u) {\n"
             "      const int s = 2 * lane + u;\n      if (s < L) {\n"
             "        const float M = fmaxf(m_in, u ? r.g1 : r.g0);\n",
             "NO_GATES", "#pragma unroll\n    for (int u = 0; u < 2; ++u) "
             "{\n      const int s = 2 * lane + u;\n      if (s < L) {\n"
             "        const GateScan r{0.f, 0.f, 0.f, 0.f, 0.f, 0.f};\n"
             "        const float M = m_in;\n")
    s = wrap(s, "      if (col + 1 < D && !(D & 1)) {\n        *reinterpret"
             "_cast<float2*>(out + col) = make_float2(x0, x1);\n      } "
             "else {\n        if (col < D) out[col] = x0;\n        if "
             "(col + 1 < D) out[col + 1] = x1;\n      }\n", "NO_STORES",
             "      if (x0 == 12345.0f && x1 == 12345.0f) out[col] = rden;\n")
    return s, {"no_qk": "NO_QK", "no_qc": "NO_QC", "no_pv": "NO_PV",
               "no_stream": "NO_STREAM", "no_stage": "NO_STAGE",
               "no_gates": "NO_GATES", "no_stores": "NO_STORES",
               "no_products": "NO_QK NO_QC NO_PV"}


def b7_staged(s):
    """The staged design, every product a `gemm_staged` call: S and dP,
    the three state products (K = D), the three intra-chunk products (K =
    L), the gate scan."""
    s = guard(s, "    gemm_staged<1, true, true>(\n        aS, D,",
              "#pragma unroll\n    for (int i = 0; i < 4; ++i) {\n"
              "      const int r = r0 + i;", "NO_SDP")
    a = s.index("  // dv = a_s (k_s dC_out) + P^T dh~.")
    b = s.index("  store(dq);")

    sec, out = s[a:b], ""
    while (i := sec.find("  gemm_staged<")) >= 0:
        j, depth = sec.index("(", i), 0
        while True:   # the call's closing parenthesis
            depth += {"(": 1, ")": -1}.get(sec[j], 0)
            if sec[j] == ")" and depth == 0:
                break
            j += 1
        j = sec.index(";", j) + 1
        kind = "NO_STATE" if "acc, D," in sec[i:j] else "NO_INTRA"
        out += sec[:i] + f"#ifndef {kind}\n{sec[i:j]}\n#endif"
        sec = sec[j:]
    s = s[:a] + out + sec + s[b:]
    a = s.index("  // Gate gradients: di = dw; df = reverse cumsum of db.")
    b = s.index("size_t outputs_smem(int NJ)")
    body = s[a:b]
    cut = body.rindex("}\n}\n") + 2
    s = s[:a] + "#ifndef NO_GATE\n" + body[:cut] + "#endif\n" + body[cut:] \
        + s[b:]
    return s, {"no_sdp": "NO_SDP", "no_state": "NO_STATE",
               "no_intra": "NO_INTRA", "no_gate": "NO_GATE",
               "none": "NO_SDP NO_STATE NO_INTRA NO_GATE"}


def b7_tensor_cores(s):
    """The tensor-core design: the products' `mma_k16` calls by kind, and
    the ring's loads (the copies into each stage)."""
    s = re.sub(r"(            mma_k16\(aS,.*?\n            mma_k16\(aP,.*?;)",
               r"#ifndef NO_SDP_MMA\n\1\n#endif", s)
    s = re.sub(r"(          for \(int kk = 0; kk < KS; kk \+= 16\)\n"
               r"            mma_k16\(acc, a_k\(s\), b_[kn]\(s\), kk, m0, "
               r"n0\);)", r"#ifndef NO_STATE_MMA\n\1\n#endif", s)
    s = re.sub(r"(          for \(int kk = 0; kk < KS; kk \+= 16\)\n"
               r"            mma_k16\(\n.*\n.*kk, m0, n0\);)",
               r"#ifndef NO_INTRA_MMA\n\1\n#endif", s)
    for head in ("  auto sdp_load = [&](int i, float* s) {\n",
                 "                         const float* state, bool rows_k)"
                 " {\n",
                 "  auto intra_slice = [&](int j, float* s, const float* "
                 "src, int64_t ld) {\n"):
        s = s.replace(head, head + "#ifdef NO_LOADS\n    return;\n#endif\n")
    off = "NO_SDP_MMA NO_STATE_MMA NO_INTRA_MMA"
    return s, {"no_sdp_mma": "NO_SDP_MMA", "no_state_mma": "NO_STATE_MMA",
               "no_intra_mma": "NO_INTRA_MMA", "no_mma": off,
               "no_loads": "NO_LOADS", "no_loads_no_mma": off + " NO_LOADS"}


def b6(s):
    """Both designs: the look-ahead wait (step 4) and step 5's row loop;
    the first's (8 warps of 12 steps) also step 5's loads again, its
    stores and dlam's atomics."""
    var = {}
    a = s.find("    Map acc = {1.0f, 0.0f};")
    b = s.find("  if (slot) {\n    s_uin[s] = uin;")
    if a >= 0 and b > a:
        body = s[a:b]
        cut = body.rindex("    }\n  }\n") + 6
        s = s[:a] + "#ifndef NO_WAIT\n" + body[:cut] + "#endif\n" \
            + body[cut:] + s[b:]
        var["no_wait"] = "NO_WAIT"
    loop = s.find("  for (int r = R - 1; r >= 0; --r) {")
    start = s.rfind("\n", 0, loop - 1) + 1   # its unroll pragma
    end = s.find("  // 6. dlam")
    if loop >= 0 and end > loop:
        s = s[:start] + "#ifndef NO_STEP5\n" + s[start:end] + "#endif\n" \
            + s[end:]
        var["no_step5"] = "NO_STEP5"
    loads = "".join(f"    const Raw<TX, V> {r} = load_raw<VEC, TX, V>({p}, "
                    "i, n);\n" for r, p in (("ra", "wa"), ("rx", "wx"),
                                           ("rv", "x")))
    dy = "    const Raw<TX, V> rd = load_raw<VEC, TX, V>(dy, i, n);\n"
    if loads + dy in s:
        s = s.replace(loads + dy, (
            "#ifndef NO_DY_RELOAD\n" + dy + "#else\n    Raw<TX, V> rd;\n"
            "    for (int w = 0; w < Raw<TX, V>::WORDS; ++w)\n"
            "      rd.w[w] = __float_as_uint(u[0] + w);\n#endif\n"
            "#ifndef NO_RELOAD\n" + loads + "#else\n"
            "    const Raw<TX, V> ra = rd, rx = rd, rv = rd;\n#endif\n"))
        var.update(no_reload="NO_RELOAD", no_dy_reload="NO_DY_RELOAD",
                   no_reloads="NO_RELOAD NO_DY_RELOAD")
        st = "    if (t < T) {\n      store_row<VEC, V>(dwa, i, nch, o_wa);"
        a = s.find(st)
        b = s.find("    }\n", s.find("store_row<VEC, V>(dx,", a)) + 6
        s = (s[:a] + "#ifndef NO_STORES\n" + s[a:b] + "#else\n    if (o_wa[0]"
             " + o_wx[1] + o_x[2] == 12345.0f) dlam[0] = 1.0f;\n#endif\n"
             + s[b:])
        at = "    atomicAdd(dlam + ch, -8.0f * sum / (1.0f + expf(-l)));\n"
        s = s.replace(at, "#ifndef NO_DLAM\n" + at + "#else\n    if (sum == "
                      "12345.0f) dlam[ch] = l;\n#endif\n")
        var.update(no_stores="NO_STORES", no_dlam="NO_DLAM")
    return s, var


def main() -> int:
    args = checkout_args(__doc__, 20)
    from repro_torch.kernels import build
    from repro_torch.models import rglru, xlstm

    csrc = Path(args.checkout).resolve() / "src/repro_torch/models/csrc"
    parts = build.build_dir() / "parts"
    parts.mkdir(parents=True, exist_ok=True)
    jobs = {}   # (kernel, variant) -> (process, library)
    for kern, fname in (("b7_outputs", "mlstm_chunk.cu"),
                        ("b7_bwd_inputs", "mlstm_chunk_bwd.cu"),
                        ("b6_bwd", "rglru_scan_bwd.cu")):
        src = (csrc / fname).read_text()
        if kern == "b7_outputs":
            src, var = (b7_fwd_fma if "tile_mma<1>(acc, qT" in src
                        else b7_fwd_wgmma)(src)
        elif kern == "b6_bwd":
            src, var = b6(src)
        elif "gemm_staged" in src:
            src, var = b7_staged(src)
        else:
            src, var = b7_tensor_cores(src)
        path = parts / fname
        path.write_text(src)
        for name, flags in {"full": "", **var}.items():
            lib = parts / f"{kern}_{name}.so"
            cmd = [build._nvcc(), *build.NVCC_FLAGS, "-I", str(csrc),
                   *(f"-D{f}" for f in flags.split()), "-o", str(lib),
                   str(path)]
            jobs[kern, name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), lib)
    libs = {}
    for key, (proc, lib) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {key}:\n{log}")
        libs[key] = lib

    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(41)
    B, H, T, D, L = 4, 4, 4096, 192, 64
    q, k, v = (torch.randn(B, T, H, D, device=dev, generator=g)
               .transpose(1, 2) for _ in range(3))
    k = k / D ** 0.5
    it = torch.randn(B, T, H, device=dev, generator=g).transpose(1, 2)
    ft = torch.nn.functional.logsigmoid(
        torch.randn(B, T, H, device=dev, generator=g) + 1.0).transpose(1, 2)
    g = torch.Generator(device=dev).manual_seed(24)
    pq, pk, pv = (torch.randn(1, 32768, H, D, device=dev, generator=g)
                  .transpose(1, 2) for _ in range(3))
    pk = pk / D ** 0.5
    pit = torch.randn(1, 32768, H, device=dev, generator=g).transpose(1, 2)
    pft = torch.nn.functional.logsigmoid(
        torch.randn(1, 32768, H, device=dev, generator=g) + 1.0) \
        .transpose(1, 2)
    rg = torch.Generator(device=dev).manual_seed(51)
    wa, wx, x, dy = (torch.randn(2, 4096, 4096, device=dev, generator=rg)
                     .to(torch.bfloat16) for _ in range(4))
    lam = (0.01 + 0.49 * torch.rand(4096, device=dev, generator=rg)).to(
        torch.bfloat16)
    dhl = torch.randn(2, 4096, device=dev, generator=rg)
    with torch.no_grad():
        st = xlstm.mlstm_state_init(B, H, D, device=dev)
        work, scal = xlstm.mlstm_chunk_states_cuda(k, v, it, ft, L)
        xlstm.mlstm_state_scan_cuda(work, scal, st)
        h, dot = xlstm.mlstm_chunk_outputs_cuda(q, k, v, it, ft, work, scal,
                                                L, with_dot=True)
        dh = torch.randn_like(h)
        dwork, dscal = xlstm.mlstm_bwd_outputs_cuda(q, dh, h, dot, it, ft,
                                                    work, scal, L)
        xlstm.mlstm_bwd_scan_cuda(dwork, dscal, work, scal, None, None, None)
        _, _, saved = rglru._forward_cuda(wa, wx, x, lam, None)
        pwork, pscal = xlstm.mlstm_chunk_states_cuda(pk, pv, pit, pft, L)
        xlstm.mlstm_state_scan_cuda(pwork, pscal,
                                    xlstm.mlstm_state_init(1, H, D,
                                                           device=dev))
        calls = {
            "b7_outputs": ("mlstm_chunk", lambda: xlstm
                           .mlstm_chunk_outputs_cuda(
                               pq, pk, pv, pit, pft, pwork, pscal, L)),
            "b7_bwd_inputs": ("mlstm_chunk_bwd", lambda: xlstm
                              .mlstm_bwd_inputs_cuda(
                                  q, k, v, it, ft, dh, h, dot, work, scal,
                                  dwork, dscal, None, L)),
            "b6_bwd": ("rglru_scan_bwd", lambda: rglru.rglru_scan_bwd_cuda(
                wa, wx, x, lam, None, saved, dy, dhl))}
        out = {"checkout": args.checkout, "reps": args.reps, **card()}
        for _ in range(2):
            for (kern, name), lib in libs.items():
                lib_name, fn = calls[kern]
                own = build.load(lib_name)
                build._LIBS[lib_name] = ctypes.CDLL(str(lib))
                try:
                    out.setdefault(kern, {}).setdefault(name, []).append(
                        time_cuda(fn, args.reps))
                finally:
                    build._LIBS[lib_name] = own
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
