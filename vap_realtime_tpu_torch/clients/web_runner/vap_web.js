/* In-browser VAP static-step runner — dependency-free JavaScript.
 *
 * Implements the same static graph as runtime/static.py (the reference's
 * VAPRealTimeStatic, tools/vap_static.py:170-304): CPC conv encoder +
 * LSTM + learned downsample, stereo AliBi transformer trunk, VAP heads,
 * with externalized embedding contexts and LSTM state.  Weights come
 * from tools/export_web.py (weights.bin + manifest.json).
 *
 * Replaces the reference's CDN-dependent onnxruntime-web / tf.js runners
 * (tools/vap_offline_onnxweb.html, vap_offline_tfjs.html) with a fully
 * offline implementation; index.html runs the exported self-test fixture
 * (must PASS before benchmarking) and the same 10-run latency harness.
 */
"use strict";

const CONV_SPECS = [[10, 5, 3], [8, 4, 2], [4, 2, 1], [4, 2, 1], [4, 2, 1]];

function erf(x) {
  // Abramowitz & Stegun 7.1.26 (|err| <= 1.5e-7)
  const s = x < 0 ? -1 : 1;
  x = Math.abs(x);
  const t = 1 / (1 + 0.3275911 * x);
  const y = 1 - (((((1.061405429 * t - 1.453152027) * t) + 1.421413741) * t
    - 0.284496736) * t + 0.254829592) * t * Math.exp(-x * x);
  return s * y;
}
const gelu = (x) => 0.5 * x * (1 + erf(x / Math.SQRT2));
const sigmoid = (x) => 1 / (1 + Math.exp(-x));

// y[m,n] = sum_k x[m,k] * W[n,k] (+ b[n])   — torch (out,in) layout
function matmulT(x, M, K, W, N, b) {
  const y = new Float32Array(M * N);
  for (let m = 0; m < M; m++) {
    const xo = m * K;
    for (let n = 0; n < N; n++) {
      let acc = 0;
      const wo = n * K;
      for (let k = 0; k < K; k++) acc += x[xo + k] * W[wo + k];
      y[m * N + n] = acc + (b ? b[n] : 0);
    }
  }
  return y;
}

function layerNorm(x, M, D, w, b) {
  const y = new Float32Array(M * D);
  for (let m = 0; m < M; m++) {
    let mean = 0;
    const o = m * D;
    for (let d = 0; d < D; d++) mean += x[o + d];
    mean /= D;
    let v = 0;
    for (let d = 0; d < D; d++) { const c = x[o + d] - mean; v += c * c; }
    v /= D; // biased (torch LayerNorm)
    const inv = 1 / Math.sqrt(v + 1e-5);
    for (let d = 0; d < D; d++) y[o + d] = (x[o + d] - mean) * inv * w[d] + b[d];
  }
  return y;
}

function softmaxRow(x, o, n) {
  let mx = -Infinity;
  for (let i = 0; i < n; i++) mx = Math.max(mx, x[o + i]);
  let s = 0;
  for (let i = 0; i < n; i++) { x[o + i] = Math.exp(x[o + i] - mx); s += x[o + i]; }
  for (let i = 0; i < n; i++) x[o + i] /= s;
}

class VapWeb {
  constructor(manifest, weights) {
    this.cfg = manifest.cfg;
    this.names = manifest.params;
    this.w = weights;
    this.D = this.cfg.dim;
    this.H = this.cfg.num_heads;
    this.T = this.cfg.context_frames;
    // AliBi slopes, power-of-2 heads: 2^(-8(h+1)/H)
    this.slopes = [];
    for (let h = 0; h < this.H; h++) this.slopes.push(Math.pow(2, -8 * (h + 1) / this.H));
    // codebook bin-sum matrices (objective.py:93-143): state bits LSB
    // first, speaker c / bin b at bit 4c+b
    this.binNow = this._binSum(0, 1);
    this.binFut = this._binSum(2, 3);
  }

  _binSum(from, to) {
    const m = new Float32Array(256 * 2);
    for (let s = 0; s < 256; s++)
      for (let c = 0; c < 2; c++) {
        let acc = 0;
        for (let b = from; b <= to; b++) acc += (s >> (4 * c + b)) & 1;
        m[s * 2 + c] = acc;
      }
    return m;
  }

  p(name) {
    const e = this.names[name];
    if (!e) throw new Error("missing param " + name);
    let size = 1;
    for (const d of e.shape) size *= d;
    return this.w.subarray(e.offset, e.offset + size);
  }

  shape(name) { return this.names[name].shape; }

  // ---- encoder -----------------------------------------------------------

  conv1d(x, Cin, L, Wt, b, Cout, K, stride, pad) {
    const Lout = Math.floor((L + 2 * pad - K) / stride) + 1;
    const y = new Float32Array(Cout * Lout);
    for (let co = 0; co < Cout; co++) {
      for (let t = 0; t < Lout; t++) {
        let acc = b ? b[co] : 0;
        const start = t * stride - pad;
        for (let ci = 0; ci < Cin; ci++) {
          const xo = ci * L, wo = (co * Cin + ci) * K;
          const k0 = Math.max(0, -start), k1 = Math.min(K, L - start);
          for (let k = k0; k < k1; k++) acc += x[xo + start + k] * Wt[wo + k];
        }
        y[co * Lout + t] = acc;
      }
    }
    return [y, Lout];
  }

  channelNorm(x, C, L, w, b) {
    // per time step across channels, UNBIASED variance
    for (let t = 0; t < L; t++) {
      let mean = 0;
      for (let c = 0; c < C; c++) mean += x[c * L + t];
      mean /= C;
      let v = 0;
      for (let c = 0; c < C; c++) { const d = x[c * L + t] - mean; v += d * d; }
      v /= (C - 1);
      const inv = 1 / Math.sqrt(v + 1e-5);
      for (let c = 0; c < C; c++)
        x[c * L + t] = (x[c * L + t] - mean) * inv * w[c] + b[c];
    }
  }

  encodeChunk(wav, h, c) {
    // wav: Float32Array(frame_samples); h, c: Float32Array(D) (mutated)
    const D = this.D;
    let x = wav, Cin = 1, L = wav.length;
    for (let i = 0; i < 5; i++) {
      const [K, S, P] = CONV_SPECS[i];
      const W = this.p(`encoder/conv${i}/w`), b = this.p(`encoder/conv${i}/b`);
      [x, L] = this.conv1d(x, Cin, L, W, b, D, K, S, P);
      Cin = D;
      this.channelNorm(x, D, L, this.p(`encoder/norm${i}/w`),
        this.p(`encoder/norm${i}/b`));
      for (let j = 0; j < x.length; j++) x[j] = Math.max(0, x[j]);
    }
    // (D, L) -> (L, D), trim first+last frame
    const Tn = L - 2;
    const z = new Float32Array(Tn * D);
    for (let t = 0; t < Tn; t++)
      for (let d = 0; d < D; d++) z[t * D + d] = x[d * L + (t + 1)];
    // LSTM (torch gate order i,f,g,o)
    const Wih = this.p("encoder/lstm/w_ih"), Whh = this.p("encoder/lstm/w_hh");
    const bih = this.p("encoder/lstm/b_ih"), bhh = this.p("encoder/lstm/b_hh");
    const y = new Float32Array(Tn * D);
    for (let t = 0; t < Tn; t++) {
      const gi = matmulT(z.subarray(t * D, (t + 1) * D), 1, D, Wih, 4 * D, bih);
      const gh = matmulT(h, 1, D, Whh, 4 * D, bhh);
      for (let d = 0; d < D; d++) {
        const ig = sigmoid(gi[d] + gh[d]);
        const fg = sigmoid(gi[D + d] + gh[D + d]);
        const gg = Math.tanh(gi[2 * D + d] + gh[2 * D + d]);
        const og = sigmoid(gi[3 * D + d] + gh[3 * D + d]);
        c[d] = fg * c[d] + ig * gg;
        h[d] = og * Math.tanh(c[d]);
        y[t * D + d] = h[d];
      }
    }
    // downsample conv (k = stride = 100//frame_hz) over (D, Tn) + LN + GELU
    const kd = this.cfg.downsample_kernel;
    const yT = new Float32Array(D * Tn);
    for (let t = 0; t < Tn; t++)
      for (let d = 0; d < D; d++) yT[d * Tn + t] = y[t * D + d];
    const [ds] = this.conv1d(yT, D, Tn, this.p("encoder/down_conv/w"),
      this.p("encoder/down_conv/b"), D, kd, kd, 0);
    // one output frame expected; take frame 0 -> (D,)
    const e = new Float32Array(D);
    const Tds = Math.floor((Tn - kd) / kd) + 1;
    for (let d = 0; d < D; d++) e[d] = ds[d * Tds + 0];
    const eLn = layerNorm(e, 1, D, this.p("encoder/down_ln/w"),
      this.p("encoder/down_ln/b"));
    for (let d = 0; d < D; d++) eLn[d] = gelu(eLn[d]);
    return eLn;
  }

  // ---- transformer trunk ---------------------------------------------------

  attention(prefix, qIn, kvIn, T) {
    // qIn/kvIn: (T, D); full-dim 1/sqrt(256) scale; AliBi + causal
    const D = this.D, H = this.H, Dh = D / H;
    const q = matmulT(qIn, T, D, this.p(prefix + "/q"), D, null);
    const k = matmulT(kvIn, T, D, this.p(prefix + "/k"), D, null);
    const v = matmulT(kvIn, T, D, this.p(prefix + "/v"), D, null);
    const scale = 1 / Math.sqrt(D);
    const y = new Float32Array(T * D);
    const row = new Float32Array(T);
    for (let h = 0; h < H; h++) {
      const m = this.slopes[h], ho = h * Dh;
      for (let i = 0; i < T; i++) {
        for (let j = 0; j <= i; j++) {
          let acc = 0;
          for (let d = 0; d < Dh; d++) acc += q[i * D + ho + d] * k[j * D + ho + d];
          row[j] = acc * scale + j * m;   // absolute-index AliBi ramp
        }
        softmaxRow(row, 0, i + 1);
        for (let d = 0; d < Dh; d++) {
          let acc = 0;
          for (let j = 0; j <= i; j++) acc += row[j] * v[j * D + ho + d];
          y[i * D + ho + d] = acc;
        }
      }
    }
    return matmulT(y, T, D, this.p(prefix + "/proj"), D, null);
  }

  layer(prefix, x, T, src) {
    const D = this.D;
    let z = layerNorm(x, T, D, this.p(prefix + "/ln_self/w"),
      this.p(prefix + "/ln_self/b"));
    const a = this.attention(prefix + "/attn", z, z, T);
    for (let i = 0; i < T * D; i++) x[i] += a[i];
    if (src) {
      z = layerNorm(x, T, D, this.p(prefix + "/ln_src/w"),
        this.p(prefix + "/ln_src/b"));
      const cA = this.attention(prefix + "/attn_cross", z, src, T);
      for (let i = 0; i < T * D; i++) x[i] += cA[i];
    }
    const hN = layerNorm(x, T, D, this.p(prefix + "/ln_ffn/w"),
      this.p(prefix + "/ln_ffn/b"));
    const dff = this.shape(prefix + "/ffn/w1")[0];
    const f1 = matmulT(hN, T, D, this.p(prefix + "/ffn/w1"), dff, null);
    for (let i = 0; i < f1.length; i++) f1[i] = gelu(f1[i]);
    const f2 = matmulT(f1, T, dff, this.p(prefix + "/ffn/w2"), D, null);
    for (let i = 0; i < T * D; i++) x[i] += f2[i];
    return x;
  }

  trunk(e1, e2, T) {
    const D = this.D;
    let o1 = Float32Array.from(e1), o2 = Float32Array.from(e2);
    for (let li = 0; li < this.cfg.channel_layers; li++) {
      o1 = this.layer(`ar_channel/layers/${li}#`, o1, T, null);
      o2 = this.layer(`ar_channel/layers/${li}#`, o2, T, null);
    }
    let x1 = Float32Array.from(o1), x2 = Float32Array.from(o2);
    for (let li = 0; li < this.cfg.cross_layers; li++) {
      const pre1 = Float32Array.from(x1), pre2 = Float32Array.from(x2);
      x1 = this.layer(`ar/layers/${li}#`, x1, T, pre2);
      x2 = this.layer(`ar/layers/${li}#`, x2, T, pre1);
    }
    // combinator: per-channel bias-free linear -> shared LN -> GELU, sum
    const ha = layerNorm(matmulT(x1, T, D, this.p("ar/combinator/h0_a"), D,
      null), T, D, this.p("ar/combinator/ln/w"), this.p("ar/combinator/ln/b"));
    const hb = layerNorm(matmulT(x2, T, D, this.p("ar/combinator/h0_b"), D,
      null), T, D, this.p("ar/combinator/ln/w"), this.p("ar/combinator/ln/b"));
    const xc = new Float32Array(T * D);
    for (let i = 0; i < T * D; i++) xc[i] = gelu(ha[i]) + gelu(hb[i]);
    return { xc, o1, o2 };
  }

  // ---- one static step -----------------------------------------------------

  // state: {e1ctx, e2ctx: Float32Array(T*D), h, c: Float32Array(2*D)}
  step(x1, x2, state) {
    const D = this.D, T = this.T;
    const e1 = this.encodeChunk(x1, state.h.subarray(0, D),
      state.c.subarray(0, D));
    const e2 = this.encodeChunk(x2, state.h.subarray(D, 2 * D),
      state.c.subarray(D, 2 * D));
    // shift-left append
    state.e1ctx.copyWithin(0, D);
    state.e1ctx.set(e1, (T - 1) * D);
    state.e2ctx.copyWithin(0, D);
    state.e2ctx.set(e2, (T - 1) * D);

    const { xc, o1, o2 } = this.trunk(state.e1ctx, state.e2ctx, T);
    const last = (T - 1) * D;
    // heads on the last frame
    const logits = matmulT(xc.subarray(last), 1, D, this.p("vap_head/w"),
      256, this.p("vap_head/b"));
    softmaxRow(logits, 0, 256);
    const agg = (mat) => {
      const p = [0, 0];
      for (let s = 0; s < 256; s++) {
        p[0] += logits[s] * mat[s * 2];
        p[1] += logits[s] * mat[s * 2 + 1];
      }
      const z = p[0] + p[1] + 1e-5;
      return [p[0] / z, p[1] / z];
    };
    const vaW = this.p("va_classifier/w"), vaB = this.p("va_classifier/b");
    const vad = [o1, o2].map((o) => {
      let acc = vaB[0];
      for (let d = 0; d < D; d++) acc += o[last + d] * vaW[d];
      return sigmoid(acc);
    });
    return { p_now: agg(this.binNow), p_future: agg(this.binFut), vad,
             e1, e2 };
  }
}

if (typeof module !== "undefined") module.exports = { VapWeb, erf };
