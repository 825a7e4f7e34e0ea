// ILANS2 shared-stream interleaved rANS on Hopper (sm_90a): the encode and
// decode kernels of the i.i.d. categorical coder at the presets (W, S) in
// {(16, 32), (32, 64)}.
//
// Replaces the Pallas kernels
//   constriction_tpu/ops/pallas_coder.py    _decode_kernel_body   (W=16, S=32)
//   constriction_tpu/ops/pallas_coder.py    _encode_kernel_body   (W=16, S=32)
//   constriction_tpu/ops/pallas_coder64.py  _decode_kernel_body64 (W=32, S=64)
//   constriction_tpu/ops/pallas_coder64.py  _encode_kernel_body64 (W=32, S=64)
// and holds the same wire format: symbol i belongs to lane i mod L; every
// lane runs the reference rANS algebra; all lanes share one word stream in
// decode-consumption order (at each step the refilling lanes take the next
// words in ascending lane order).
//
// What bounds them on this card: the T coding steps of a lane form a serial
// chain of dependent loads and arithmetic, and the lanes meet in the word
// stream, whose positions need an exclusive count over all L lanes at each
// step (refill ranks when decoding, emission offsets when encoding).  Both
// presets run ilans2_wide.cuh's design, instantiated at (W, S):
//
// - Decode: a cluster of up to 16 CTAs (one SM each) with the lane states
//   in registers for the whole message and one distributed-shared-memory
//   exchange and cluster barrier per step.  BucketCdfModel puts a bucket
//   table of 2^lut_bits + 1 entries, lut_bits = min(P, 12), in front of the
//   CDF search.  At P <= 12 (the small preset's facade default, P=12) the
//   table maps every quantile to its symbol and the lane searches nothing;
//   at P = 13..16 and P = 24 a quantile's bucket spans 2^(P - 12) quantiles
//   and a short binary search of the CDF between two entries finishes it.
// - Encode: no cross-lane dependency in the state algebra, so a
//   lane-parallel pass over the whole grid (one thread per lane, every
//   emitted word into a dense scratch, one renorm ballot per step and 32
//   lanes; the division by the symbol's probability a multiply-high by a
//   per-symbol reciprocal, RecordCdfModel over DivisionRecord at S=64 or
//   DivisionRecord32 at S=32) and a row-major compaction (a scan of the
//   ballots' popcounts and a scatter of the flagged words), which moves
//   one word per u32 at either preset.
//
// At S=32 the state stays a uint32_t (P <= 16, words masked to 16 bits):
// the decode's (x >> P) * prob + (q - cum) < 2^(32-P) prob <= 2^32 (the K=1
// model, prob = 2^P, gives x back), and the encode's (x / prob) << P |
// (cum + x % prob) < 2^32, since a lane holds x < prob 2^(32-P) when it
// codes (one that emitted a word holds x < 2^16).
//
// The cluster size follows L (auto_cluster) and the geometry entries report
// it.  The L a cluster reaches is 16 * 32 * 32 * 32 lanes (32 lanes a
// thread); a larger L returns an error.
//
// Both models are ilans2_wide.cuh's: the decode's (BucketCdfModel) is
// shared with the range decode (ilans2_range.cu), the encode's
// (RecordCdfModel, one CDF's division records) with the TChain-24 encode
// (tchain.cu).  The CDF staging and the symbol search are in lanes.cuh.

#include "ilans2_wide.cuh"

namespace {

// The lane counts, alphabets and precisions a preset takes (P <= S - W:
// the renorm keeps a state's top word nonzero).
template <int W, int S>
bool preset_args(int L, int P, int K) {
  return valid_args(L, P, K) && P <= S - W;
}

// The cluster decode; `cluster` 0 picks the cluster size from L.
template <int W, int S>
int launch_cluster_decode(void* states, const void* stream, long long slen,
                          const void* cdf, int K, void* syms, long long n,
                          int L, int P, int cluster, void* cuda_stream,
                          int device) {
  if (!preset_args<W, S>(L, P, K)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  BucketCdfModel model{static_cast<const uint32_t*>(cdf), K, 0, P, 0,
                       nullptr};
  const size_t bytes = bucket_smem_bytes(&model);
  ClusterGeometry geo;
  ClusterDecodeFn<W, S, BucketCdfModel, false> kernel;
  cudaError_t err = plan_cluster_decode<W, S, BucketCdfModel, false>(
      L, cluster, bytes, device, &geo, &kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const int T = static_cast<int>((n + L - 1) / L);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(
      geo, bytes, static_cast<cudaStream_t>(cuda_stream), &attr);
  err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<typename StateOf<S>::type*>(states),
      static_cast<const uint32_t*>(stream), static_cast<int64_t>(slen), model,
      static_cast<int32_t*>(syms), static_cast<int64_t>(n), L, P, T,
      geo.groups_per_cta, static_cast<int64_t*>(nullptr));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The encode, pass A: the division records of the CDF's symbols into
// records[K], then the lanes.
template <int W, int S>
int launch_encode_lanes(void* states, const void* syms, long long n,
                        const void* cdf, int K, void* words, void* flags,
                        void* records, int L, int P, void* cuda_stream,
                        int device) {
  using Record = typename RecordOf<S>::type;
  using Model = RecordCdfModel<Record>;
  if (!preset_args<W, S>(L, P, K)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Model model{static_cast<const int32_t*>(syms),
              static_cast<const Record*>(records), K, 0};
  const size_t bytes = record_smem_bytes(&model);
  auto kernel = encode_lanes_kernel<W, S, Model>;
  cudaError_t err = prepare(kernel, device, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const auto stream = static_cast<cudaStream_t>(cuda_stream);
  division_records_kernel<Record><<<ceil_div(K, 128), 128, 0, stream>>>(
      static_cast<const uint32_t*>(cdf), K, static_cast<Record*>(records));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int T = static_cast<int>((n + L - 1) / L);
  kernel<<<ceil_div(L, kLaneThreads), kLaneThreads, bytes, stream>>>(
      static_cast<typename StateOf<S>::type*>(states), model, n,
      static_cast<uint32_t*>(words), static_cast<uint32_t*>(flags), L, P, T);
  return static_cast<int>(cudaGetLastError());
}

// Both passes: words[T * L], flags[T * L / 32], offsets[kScanBlocks] (u64)
// and records[K] are scratch the caller allocates.
template <int W, int S>
int launch_encode(void* states, const void* syms, long long n,
                  const void* cdf, int K, void* buf, long long cap,
                  void* end_out, void* words, void* flags, void* offsets,
                  void* records, int L, int P, void* cuda_stream, int device) {
  const int err = launch_encode_lanes<W, S>(states, syms, n, cdf, K, words,
                                            flags, records, L, P, cuda_stream,
                                            device);
  if (err != 0 || n <= 0) return err;
  const long long n_flags = (n + L - 1) / L * (L / 32);
  return launch_compact(flags, words, n_flags, buf, cap, end_out, offsets,
                        cuda_stream, device);
}

// The decode's and the encode's launch geometry for L lanes, K symbols and
// precision P (`cluster` 0: the size the decode picks), into out[10]:
// cluster size, groups per CTA, lanes per thread, threads per CTA, the
// card's maximum of active clusters of that shape, the decode's dynamic
// shared memory bytes, whether the CDF is in shared memory, the bucket
// table's lut_bits; pass A's blocks and threads.
template <int W, int S>
int geometry(int L, int K, int P, int cluster, long long* out, int device) {
  if (!preset_args<W, S>(L, P, K)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  BucketCdfModel model{nullptr, K, 0, P, 0, nullptr};
  const size_t bytes = bucket_smem_bytes(&model);
  ClusterGeometry geo;
  ClusterDecodeFn<W, S, BucketCdfModel, false> kernel;
  const cudaError_t err = plan_cluster_decode<W, S, BucketCdfModel, false>(
      L, cluster, bytes, device, &geo, &kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long vals[10] = {geo.cluster, geo.groups_per_cta, geo.rows,
                              geo.threads, geo.max_active_clusters,
                              static_cast<long long>(bytes),
                              model.cdf_in_smem, model.lut_bits,
                              ceil_div(L, kLaneThreads), kLaneThreads};
  for (int k = 0; k < 10; ++k) out[k] = vals[k];
  return 0;
}

}  // namespace

// Plain C interface, bound with ctypes (constriction_tpu_torch/ops/_build.py).
// Each entry launches on the given stream, synchronises nothing, allocates
// nothing, and returns cudaGetLastError() (0 on success).
extern "C" {

int ctt_ilans2_decode_w16s32(void* states, const void* stream, long long slen,
                             const void* cdf, int K, void* syms, long long n,
                             int L, int P, void* cuda_stream, int device) {
  return launch_cluster_decode<16, 32>(states, stream, slen, cdf, K, syms, n,
                                       L, P, 0, cuda_stream, device);
}

int ctt_ilans2_decode_w32s64(void* states, const void* stream, long long slen,
                             const void* cdf, int K, void* syms, long long n,
                             int L, int P, void* cuda_stream, int device) {
  return launch_cluster_decode<32, 64>(states, stream, slen, cdf, K, syms, n,
                                       L, P, 0, cuda_stream, device);
}

// The same decodes on a cluster of `cluster` CTAs (1 .. 16).
int ctt_ilans2_decode_cluster_w16s32(void* states, const void* stream,
                                     long long slen, const void* cdf, int K,
                                     void* syms, long long n, int L, int P,
                                     int cluster, void* cuda_stream,
                                     int device) {
  if (cluster < 1) return static_cast<int>(cudaErrorInvalidValue);
  return launch_cluster_decode<16, 32>(states, stream, slen, cdf, K, syms, n,
                                       L, P, cluster, cuda_stream, device);
}

int ctt_ilans2_decode_cluster_w32s64(void* states, const void* stream,
                                     long long slen, const void* cdf, int K,
                                     void* syms, long long n, int L, int P,
                                     int cluster, void* cuda_stream,
                                     int device) {
  if (cluster < 1) return static_cast<int>(cudaErrorInvalidValue);
  return launch_cluster_decode<32, 64>(states, stream, slen, cdf, K, syms, n,
                                       L, P, cluster, cuda_stream, device);
}

int ctt_ilans2_geometry_w16s32(int L, int K, int P, int cluster,
                               long long* out, void* cuda_stream,
                               int device) {
  (void)cuda_stream;
  return geometry<16, 32>(L, K, P, cluster, out, device);
}

int ctt_ilans2_geometry_w32s64(int L, int K, int P, int cluster,
                               long long* out, void* cuda_stream,
                               int device) {
  (void)cuda_stream;
  return geometry<32, 64>(L, K, P, cluster, out, device);
}

// Both passes of the encodes (records[K]: 8 bytes each at S=32, 16 at
// S=64).
int ctt_ilans2_encode_w16s32(void* states, const void* syms, long long n,
                             const void* cdf, int K, void* buf, long long cap,
                             void* end_out, void* words, void* flags,
                             void* offsets, void* records, int L, int P,
                             void* cuda_stream, int device) {
  return launch_encode<16, 32>(states, syms, n, cdf, K, buf, cap, end_out,
                               words, flags, offsets, records, L, P,
                               cuda_stream, device);
}

int ctt_ilans2_encode_w32s64(void* states, const void* syms, long long n,
                             const void* cdf, int K, void* buf, long long cap,
                             void* end_out, void* words, void* flags,
                             void* offsets, void* records, int L, int P,
                             void* cuda_stream, int device) {
  return launch_encode<32, 64>(states, syms, n, cdf, K, buf, cap, end_out,
                               words, flags, offsets, records, L, P,
                               cuda_stream, device);
}

// Pass A alone (records[K] is scratch).
int ctt_ilans2_encode_lanes_w16s32(void* states, const void* syms,
                                   long long n, const void* cdf, int K,
                                   void* words, void* flags, void* records,
                                   int L, int P, void* cuda_stream,
                                   int device) {
  return launch_encode_lanes<16, 32>(states, syms, n, cdf, K, words, flags,
                                     records, L, P, cuda_stream, device);
}

int ctt_ilans2_encode_lanes_w32s64(void* states, const void* syms,
                                   long long n, const void* cdf, int K,
                                   void* words, void* flags, void* records,
                                   int L, int P, void* cuda_stream,
                                   int device) {
  return launch_encode_lanes<32, 64>(states, syms, n, cdf, K, words, flags,
                                     records, L, P, cuda_stream, device);
}

// Pass B alone (either preset: one word per u32).
int ctt_ilans2_compact(const void* flags, const void* words, long long n_flags,
                       void* buf, long long cap, void* end_out, void* offsets,
                       void* cuda_stream, int device) {
  return launch_compact(flags, words, n_flags, buf, cap, end_out, offsets,
                        cuda_stream, device);
}

const char* ctt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Reads and resets the runtime's last error: an entry that failed in a
// runtime call leaves it set, and the next entry would return it as its
// own.
int ctt_clear_error() { return static_cast<int>(cudaGetLastError()); }

}  // extern "C"
