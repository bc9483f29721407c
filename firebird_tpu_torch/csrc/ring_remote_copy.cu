// ring_remote_copy: one hop of the straggler-rebalancing ring, one source
// shard's payload copied into the buffer its ring neighbour receives.
//
// Replaces the Pallas kernel firebird_tpu/ccd/pallas_ops.py::ring_remote_copy
// (_ring_copy_kernel), which ships a shard-local array to the neighbouring
// TPU with make_async_remote_copy and waits on its send and receive DMA
// semaphores.  Here one launch per source shard and hop copies every leaf
// of the payload into one flat receive buffer, each leaf at a 256-byte
// aligned offset (cuda_ops.ring_plan).  The destination is written straight
// from the source device: on one card the same device, across cards a peer
// device after fb_ring_enable_peer (cudaDeviceEnablePeerAccess), the NVLink
// stores taking the place of the remote DMA.  The wrapper records an event
// after the launch and makes the receiver's stream wait on it: that is the
// receive semaphore's part.  There is no other path: a pair of devices
// without peer access is refused.
//
// Bound: bytes.  Every payload byte is read once and written once.  The
// payload is cut into equal spans, each inside one leaf (the last of a leaf
// shorter); the table of spans is built once per payload signature and
// lives on the device.  A persistent grid of BLOCKS_PER_SM blocks an SM
// walks the spans; each thread keeps UNROLL 16-byte loads in flight before
// it stores them, with streaming hints (the data is touched once).  A span
// whose source is not 16-byte aligned (a view into a larger tensor), and
// the last bytes of a leaf that is not a multiple of 16, are copied byte by
// byte.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int MAX_LEAVES = 128;
constexpr int THREADS = 256;
constexpr int BLOCKS_PER_SM = 4;
constexpr int UNROLL = 4;

// One span: bytes [leaf_off, leaf_off + len) of leaf ``leaf``, received at
// byte dst_off of the flat buffer (cuda_ops.ring_plan's rows, int64).
struct Span {
  long long dst_off;
  long long leaf_off;
  long long len;
  long long leaf;
};

// The leaves' source addresses, passed by value (1 KB of the 4 KB of
// kernel parameters).
struct Sources {
  const unsigned char* src[MAX_LEAVES];
};

__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
ring_copy_kernel(const __grid_constant__ Sources srcs,
                 const Span* __restrict__ spans, int n_spans,
                 unsigned char* __restrict__ dst) {
  for (int k = blockIdx.x; k < n_spans; k += gridDim.x) {
    const Span sp = spans[k];
    const unsigned char* s = srcs.src[sp.leaf] + sp.leaf_off;
    unsigned char* d = dst + sp.dst_off;
    long long done = 0;
    // The destination offset is a multiple of 16 (ring_plan).
    if ((reinterpret_cast<uintptr_t>(s) & 15) == 0) {
      const long long n16 = sp.len >> 4;
      const uint4* s4 = reinterpret_cast<const uint4*>(s);
      uint4* d4 = reinterpret_cast<uint4*>(d);
      const long long step = (long long)THREADS * UNROLL;
      for (long long i = threadIdx.x; i < n16; i += step) {
        uint4 v[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const long long j = i + (long long)u * THREADS;
          if (j < n16) v[u] = __ldcs(s4 + j);
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const long long j = i + (long long)u * THREADS;
          if (j < n16) __stcs(d4 + j, v[u]);
        }
      }
      done = n16 << 4;
    }
    for (long long i = done + threadIdx.x; i < sp.len; i += THREADS)
      d[i] = s[i];
  }
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      n = 0;
  }
  return n;
}

}  // namespace

// srcs: n_leaves source addresses (int64, host memory); spans: n_spans rows
// of Span on the device of ``stream``; dst: the flat receive buffer (on
// that device or on a peer with access enabled).
extern "C" int fb_ring_remote_copy(const long long* srcs, int n_leaves,
                                   const void* spans, int n_spans, void* dst,
                                   void* stream) {
  if (n_leaves < 1 || n_leaves > MAX_LEAVES || n_spans < 1)
    return (int)cudaErrorInvalidValue;
  Sources s = {};
  for (int i = 0; i < n_leaves; ++i)
    s.src[i] = reinterpret_cast<const unsigned char*>(srcs[i]);
  const int sms = sm_count();
  if (sms < 1) return (int)cudaErrorInvalidDevice;
  const int grid = n_spans < sms * BLOCKS_PER_SM ? n_spans
                                                  : sms * BLOCKS_PER_SM;
  ring_copy_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      s, (const Span*)spans, n_spans, (unsigned char*)dst);
  return (int)cudaGetLastError();
}

// The blocks of ring_copy_kernel resident on one SM (the occupancy the
// persistent grid is sized for).
extern "C" int fb_ring_remote_copy_blocks_per_sm(int* blocks) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, ring_copy_kernel, THREADS, 0);
}

// Let ``device`` write into ``peer``'s memory; fails (without falling back
// to anything) where the pair has no peer access.  The current device is
// restored.
extern "C" int fb_ring_enable_peer(int device, int peer) {
  int ok = 0;
  cudaError_t e = cudaDeviceCanAccessPeer(&ok, device, peer);
  if (e != cudaSuccess) return (int)e;
  if (!ok) return (int)cudaErrorPeerAccessUnsupported;
  int prev = 0;
  e = cudaGetDevice(&prev);
  if (e != cudaSuccess) return (int)e;
  e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceEnablePeerAccess(peer, 0);
  if (e == cudaErrorPeerAccessAlreadyEnabled) {
    cudaGetLastError();  // clear the sticky-free status
    e = cudaSuccess;
  }
  cudaError_t r = cudaSetDevice(prev);
  return (int)(e != cudaSuccess ? e : r);
}
