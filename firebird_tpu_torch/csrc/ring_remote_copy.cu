// ring_remote_copy: one hop of the straggler-rebalancing ring, one source
// shard's payload copied into the buffers its ring neighbour receives.
//
// Replaces the Pallas kernel firebird_tpu/ccd/pallas_ops.py::ring_remote_copy
// (_ring_copy_kernel), which ships a shard-local array to the neighbouring
// TPU with make_async_remote_copy and waits on its send and receive DMA
// semaphores.  Here one launch per source shard and hop carries a table of
// every leaf of the payload (source pointer, destination pointer, bytes):
// blockIdx.y picks the leaf, the x blocks stride over its bytes.  The
// destination is the receiver's buffer, written straight from the source
// device: on one card the same device, across cards a peer device after
// fb_ring_enable_peer (cudaDeviceEnablePeerAccess), the NVLink stores
// taking the place of the remote DMA.  The wrapper records an event after
// the launch and makes the receiver's stream wait on it: that is the
// receive semaphore's part.  There is no other path: a pair of devices
// without peer access is refused.
//
// Bound: bytes.  Every payload byte is read once and written once; a
// thread moves 16 bytes at a time (uint4) where the source and the
// destination are both 16-byte aligned, and single bytes for the rest.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int MAX_LEAVES = 128;
constexpr int THREADS = 256;
constexpr int MAX_BLOCKS_X = 1024;

// Passed by value (3 KB of the 4 KB of kernel parameters).
struct Table {
  const unsigned char* src[MAX_LEAVES];
  unsigned char* dst[MAX_LEAVES];
  long long bytes[MAX_LEAVES];
};

__global__ void __launch_bounds__(THREADS)
ring_copy_kernel(const __grid_constant__ Table tab) {
  const int leaf = blockIdx.y;
  const unsigned char* s = tab.src[leaf];
  unsigned char* d = tab.dst[leaf];
  const long long n = tab.bytes[leaf];
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long done = 0;
  if (((reinterpret_cast<uintptr_t>(s) | reinterpret_cast<uintptr_t>(d)) &
       15) == 0) {
    const long long n16 = n >> 4;
    const uint4* s4 = reinterpret_cast<const uint4*>(s);
    uint4* d4 = reinterpret_cast<uint4*>(d);
    for (long long i = first; i < n16; i += stride) d4[i] = s4[i];
    done = n16 << 4;
  }
  for (long long i = done + first; i < n; i += stride) d[i] = s[i];
}

}  // namespace

// table: n_leaves rows of (source address, destination address, bytes) as
// int64, in host memory; every address on the device of ``stream`` or on a
// peer of it with access enabled.
extern "C" int fb_ring_remote_copy(const long long* table, int n_leaves,
                                   void* stream) {
  if (n_leaves < 1 || n_leaves > MAX_LEAVES) return (int)cudaErrorInvalidValue;
  Table tab = {};
  long long most = 0;
  for (int i = 0; i < n_leaves; ++i) {
    tab.src[i] = reinterpret_cast<const unsigned char*>(table[3 * i]);
    tab.dst[i] = reinterpret_cast<unsigned char*>(table[3 * i + 1]);
    tab.bytes[i] = table[3 * i + 2];
    if (tab.bytes[i] < 0) return (int)cudaErrorInvalidValue;
    if (tab.bytes[i] > most) most = tab.bytes[i];
  }
  long long blocks = ((most + 15) / 16 + THREADS - 1) / THREADS;
  if (blocks < 1) blocks = 1;
  if (blocks > MAX_BLOCKS_X) blocks = MAX_BLOCKS_X;
  ring_copy_kernel<<<dim3((unsigned)blocks, (unsigned)n_leaves), THREADS, 0,
                     (cudaStream_t)stream>>>(tab);
  return (int)cudaGetLastError();
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
