// Batch keccak-256 on the H100: one thread a message, 32 digest bytes a
// message out. Three forms of one body (hash_kernel.cuh):
//   packed   (keccak256_launch)         any packed batch: hash_batch, merkle
//   tx hash  (keccak256_tx_hash_launch) admit_batch's payloads -> digests
//            and z as the recover kernel's [B, 16] limbs
//   sender   (keccak256_sender_launch)  the recover kernel's qx, qy limbs
//            -> right160(keccak(x ‖ y)) and the key's 64 bytes
//
// Replaces the JAX package's keccak256_blocks (fisco_bcos_tpu/ops/keccak.py)
// and its sender_address_device (fisco_bcos_tpu/ops/address.py), jitted
// sponges over blocks padded on the host or inline, which the TPU ran
// outside any Pallas kernel; the port's plain versions are
// keccak256_packed_plain, keccak256_tx_hash_plain (ops/keccak.py) and
// sender_address_plain (ops/address.py).
//
// What bounds it: integer instructions. A permutation takes about 4.3 k
// 32-bit instructions counted as one each (a 3-input logic op, a funnel
// shift): chip_smoke.py's KECCAK_F_OPS. The bytes (each message read once,
// 32 bytes written) are under a tenth of that at the main path's 97-byte
// payloads. A 10,240-message batch is 320 warps for 528 schedulers, so the
// kernel runs at one warp's pace. So the design keeps the warp's stream
// short around the permutation: messages staged through shared memory
// with coalesced 16-byte copies and read back as words, results leaving as
// coalesced rows, and the forms read and write what the EC kernel beside
// them takes and gives, so no torch op runs between the launches.

#include "keccak256.cuh"

#ifdef __CUDACC__

extern "C" void keccak256_geometry(int n, int* out) { hash_geometry(n, HASH_PACKED_SMEM, out); }

// C entry points for ctypes, all pointers on `device`. data uint8, starts
// int64 [n], lengths int32 [n], out uint8 [n, 32], limbs int32 [n, 16];
// n_data the bytes of data; routes int32 [2] or null.
extern "C" int keccak256_launch(const void* data, const void* starts, const void* lengths,
                                void* out, void* routes, int n, long long n_data, int device,
                                void* stream) {
  return packed_hash_launch<Keccak256, false>(data, starts, lengths, out, nullptr, routes, n,
                                              n_data, device, stream);
}

extern "C" int keccak256_tx_hash_launch(const void* data, const void* starts, const void* lengths,
                                        void* out, void* limbs, void* routes, int n,
                                        long long n_data, int device, void* stream) {
  return packed_hash_launch<Keccak256, true>(data, starts, lengths, out, limbs, routes, n, n_data,
                                             device, stream);
}

// qx, qy int32 [n, 16]; ok bool [n] or null; addr uint8 [n, 20]; pub uint8
// [n, 64].
extern "C" int keccak256_sender_launch(const void* qx, const void* qy, const void* ok, void* addr,
                                       void* pub, int n, int device, void* stream) {
  return sender_launch<Keccak256>(qx, qy, ok, addr, pub, n, device, stream);
}

#endif  // __CUDACC__
