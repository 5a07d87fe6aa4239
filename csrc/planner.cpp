// Native planner — the equivalent of the reference's host
// utility layer (src/cudaConvFFTData.h: iDivUp/iAlignUp grid math,
// computeFFTsize/computeFFTsize16 FFT-size policies) plus the execution
// planning the streams variant hard-codes (src/cudaConvFFTDataStreams.cu:
// N_BATCH_PER_GPU=2 double buffering, fixed round-robin).
//
// Exposed as a plain C ABI consumed from Python via ctypes
// (cuda_fft_convolution_tpu/runtime/native.py). The Python implementations
// in utils/fft_size.py are the semantic definition of record; this library
// must match them bit-for-bit (tests/test_runtime.py cross-checks).
//
// Build: g++ -O2 -shared -fPIC -o libfftconv_planner.so planner.cpp

#include <cstdint>
#include <initializer_list>

extern "C" {

// ceil(a / b) — reference iDivUp (src/cudaConvFFTData.h:36).
int64_t ffc_ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

// round a up to a multiple of b — reference iAlignUp (src/cudaConvFFTData.h:41).
int64_t ffc_align_up(int64_t a, int64_t b) { return ffc_ceil_div(a, b) * b; }

// round up to a multiple of 16 — reference computeFFTsize16
// (src/cudaConvFFTData.h:96).
int64_t ffc_next_multiple_of_16(int64_t n) {
  return ffc_align_up(n < 1 ? 1 : n, 16);
}

// align to 16 then next power of two — reference computeFFTsize
// (src/cudaConvFFTData.h:67).
int64_t ffc_next_pow2(int64_t n) {
  n = ffc_align_up(n < 1 ? 1 : n, 16);
  int64_t p = 1;
  while (p < n) p <<= 1;
  return p;
}

static bool is_5_smooth(int64_t m) {
  for (int64_t p : {2, 3, 5}) {
    while (m % p == 0) m /= p;
  }
  return m == 1;
}

// smallest 5-smooth integer >= n (XLA-FFT-friendly sizes).
int64_t ffc_next_fast_len(int64_t n) {
  if (n < 1) n = 1;
  if (n <= 5) return n;
  while (!is_5_smooth(n)) ++n;
  return n;
}

// FFT-size policy dispatch; must match utils/fft_size.py:compute_fft_size.
// policy: 0=multiple16, 1=pow2, 2=fast.
void ffc_compute_fft_size(int64_t data_h, int64_t data_w, int64_t max_kh,
                          int64_t max_kw, int32_t policy, int64_t* out_h,
                          int64_t* out_w) {
  const int64_t need_h = data_h + max_kh - 1;
  const int64_t need_w = data_w + max_kw - 1;
  switch (policy) {
    case 0:
      *out_h = ffc_next_multiple_of_16(need_h);
      *out_w = ffc_next_multiple_of_16(need_w);
      return;
    case 1:
      *out_h = ffc_next_pow2(need_h);
      *out_w = ffc_next_pow2(need_w);
      return;
    default:
      *out_h = ffc_next_fast_len(need_h);
      *out_w = ffc_next_fast_len(need_w);
      return;
  }
}

// Bank execution plan: choose the kernel-chunk size for the pipelined bank
// loop so that one chunk's working set (chunk spectra + products + output
// maps, all live at once while the next chunk overlaps) fits the memory
// budget — the decision src/cudaConvFFTDataStreams.cu bakes in as
// "2 streams x 1 kernel each".
//
// Inputs: bank size n, feature dim f, fft dims, batch b, memory budget bytes,
// spectra store width in bytes (4 = f32 tier, 2 = the bf16 serving tier —
// data/bank/product spectra all halve; output maps stay f32).
// Outputs: chunk size (>=1) and estimated peak working-set bytes.
void ffc_plan_bank(int64_t n, int64_t f, int64_t fft_h, int64_t fft_w,
                   int64_t b, int64_t hbm_budget_bytes, int64_t store_bytes,
                   int64_t* out_chunk, int64_t* out_peak_bytes) {
  const int64_t wc = fft_w / 2 + 1;
  // Nominal bytes: device arrays take their element count times width.
  const int64_t spec = fft_h * wc * 2 * store_bytes;
  const int64_t map = fft_h * fft_w * 4;
  // Fixed: data spectra (b*f planes), input data, the RESIDENT bank spectra
  // (n*f planes), and the full output maps (b*n) — all live for the whole
  // call regardless of chunking.
  const int64_t fixed =
      b * f * spec + b * f * fft_h * fft_w * 4 + n * f * spec + b * n * map;
  // UNCHUNKED working set per kernel: products (b planes) + inverse scratch
  // (~2 maps); x2 for producer/consumer overlap. For f > 1 keep a
  // bank/16 slack for the F-contraction's operand relayouts (a full
  // bank-sized allowance would force chunked plans, and a chunked pass
  // pays a bank-slice copy per chunk).
  const int64_t per_unchunked = 2 * (b * spec + 2 * b * map);
  const int64_t unchunked_extra = (f > 1) ? (n * f * spec) / 16 : 0;
  int64_t budget = hbm_budget_bytes - fixed;
  if (budget >= n * per_unchunked + unchunked_extra) {
    // Whole bank in one pass (a chunked lax.map pays a bank-slice COPY per
    // chunk).
    *out_chunk = n;
    *out_peak_bytes = fixed + n * per_unchunked + unchunked_extra;
    return;
  }
  // Chunked: each chunk's working set adds a bank-slice copy PLUS its
  // F-contraction relayout (f planes each, f > 1) on top of products/maps;
  // x2 for double buffering.
  const int64_t slice_copies = (f > 1) ? 2 * f * spec : f * spec;
  const int64_t per_chunked = 2 * (slice_copies + b * spec + b * (3 * map));
  if (budget < per_chunked) budget = per_chunked;
  int64_t chunk = budget / per_chunked;
  if (chunk > n) chunk = n;
  if (chunk < 1) chunk = 1;
  *out_chunk = chunk;
  *out_peak_bytes = fixed + chunk * per_chunked;
}

// ---------------------------------------------------------------------------
// Overlap-save block geometry (analytic planner) — native mirror of
// ops/tiled.py:choose_block_fft's analytic rules. The Python side remains
// the definition of record and additionally overlays the tuned geometry
// table (runtime/autotune.py) before falling back to these rules.
// ---------------------------------------------------------------------------

static int64_t pad8(int64_t x) { return ffc_align_up(x, 8); }
static int64_t pad128(int64_t x) { return ffc_align_up(x, 128); }

// Analytic overlap-save block plan — mirrors the fallback rules of
// ops/tiled.py:choose_block_fft (the measured-table overlay happens in
// Python before this). Returns 1 and fills (block_h, block_w, plan_kh,
// plan_kw) when tiling pays, 0 when the direct engine should run.
// matmul_engine: 1 = matmul-DFT transform engine (any size; wants small
// rounded valid windows), 0 = XLA-FFT engine (5-smooth sizes, larger
// blocks).
int32_t ffc_choose_block_fft(int64_t data_h, int64_t data_w, int64_t max_kh,
                             int64_t max_kw, int32_t matmul_engine,
                             int64_t max_block, int64_t* out_lh,
                             int64_t* out_lw, int64_t* out_pkh,
                             int64_t* out_pkw) {
  int64_t lh, lw;
  if (matmul_engine) {
    // Valid window rounded (Vh to 8, Vw to 128); H blocks small (Vh ≈ K),
    // W blocks wider (Vw ≈ 6·K) — see choose_block_fft.
    const int64_t vh0 = pad8(max_kh - 1) > 8 ? pad8(max_kh - 1) : 8;
    const int64_t vw0 = pad128(6 * (max_kw - 1)) > 128
                            ? pad128(6 * (max_kw - 1))
                            : 128;
    lh = vh0 + max_kh - 1;
    if (lh > max_block) lh = max_block;
    lw = vw0 + max_kw - 1;
    if (lw > max_block) lw = max_block;
    if (lh < 2 * (max_kh - 1) || lw < 2 * (max_kw - 1)) return 0;
  } else {
    const int64_t th = 8 * max_kh > 128 ? 8 * max_kh : 128;
    const int64_t tw = 8 * max_kw > 128 ? 8 * max_kw : 128;
    lh = ffc_next_fast_len(th < max_block ? th : max_block);
    lw = ffc_next_fast_len(tw < max_block ? tw : max_block);
    if (lh < 4 * (max_kh - 1) || lw < 4 * (max_kw - 1)) return 0;
  }
  if (data_h + max_kh - 1 <= 2 * lh && data_w + max_kw - 1 <= 2 * lw)
    return 0;
  *out_lh = lh;
  *out_lw = lw;
  *out_pkh = max_kh;
  *out_pkw = max_kw;
  return 1;
}

// ABI version for the ctypes loader's compatibility check.
// Bump on ANY semantic change to the exported models, not just signature
// changes — the version gate (runtime/native.py) is what protects the
// bit-for-bit Python/C++ contract when a stale prebuilt .so escapes the
// mtime rebuild check. v5: nominal-byte bank model; policy 3 and the
// fused-kernel memory model removed.
int32_t ffc_abi_version() { return 5; }

}  // extern "C"
