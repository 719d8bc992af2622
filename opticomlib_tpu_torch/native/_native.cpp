// Host helpers of opticomlib_tpu_torch (the same source as the JAX
// package's native library).
//
// The card runs the simulation; this library covers the serial,
// bit-twiddling host work that Python would otherwise do in interpreted
// loops:
//
//  * lfsr_prbs       - bit-serial Galois LFSR (the reference's PRBS loop,
//                      reference opticomlib/devices.py:170-175, at native
//                      speed; the independent oracle for the O(log n)
//                      vectorized generator in ops/prbs.py)
//  * bit_error_count - error counting over byte-per-bit arrays
//  * pack_bits / unpack_bits - bit packing for waveform/bitstream I/O
//
// Built on first use by opticomlib_tpu_torch.native with g++ -O3 into
// build/native/ at the repository root; no external dependencies.
#include <cstdint>
#include <cstddef>

extern "C" {

// Emit n output bits of the PRBS-`order` stream from `seed`.
// Matches ops/prbs.py::_bootstrap: output = LSB; feedback
// ((s >> (tap1-1)) ^ (s >> (tap2-1))) & 1 shifted into the LSB.
// Returns the final LFSR state (continuation seed).
uint64_t lfsr_prbs(int order, int tap2, uint64_t seed, int64_t n,
                   uint8_t* out) {
    const int t1 = order - 1;
    const int t2 = tap2 - 1;
    const uint64_t mask = (order >= 64) ? ~0ULL : ((1ULL << order) - 1ULL);
    uint64_t s = seed & mask;
    for (int64_t i = 0; i < n; ++i) {
        out[i] = static_cast<uint8_t>(s & 1ULL);
        const uint64_t nb = ((s >> t1) ^ (s >> t2)) & 1ULL;
        s = ((s << 1) | nb) & mask;
    }
    return s;
}

// Count positions where a[i] != b[i] (byte-per-bit arrays).
int64_t bit_error_count(const uint8_t* a, const uint8_t* b, int64_t n) {
    int64_t errs = 0;
    int64_t i = 0;
    // word-at-a-time: XOR 8 bytes, popcount of nonzero bytes
    const int64_t nw = n / 8;
    const uint64_t* wa = reinterpret_cast<const uint64_t*>(a);
    const uint64_t* wb = reinterpret_cast<const uint64_t*>(b);
    for (int64_t w = 0; w < nw; ++w) {
        uint64_t x = wa[w] ^ wb[w];
        // byte-wise "nonzero" -> 0x01 per differing byte
        x = (x | (x >> 4));
        x = (x | (x >> 2));
        x = (x | (x >> 1)) & 0x0101010101010101ULL;
        errs += static_cast<int64_t>(__builtin_popcountll(x));
    }
    for (i = nw * 8; i < n; ++i) errs += (a[i] != b[i]) ? 1 : 0;
    return errs;
}

// Pack byte-per-bit (LSB-first within each output byte).
void pack_bits(const uint8_t* bits, int64_t n, uint8_t* out) {
    const int64_t nbytes = (n + 7) / 8;
    for (int64_t b = 0; b < nbytes; ++b) out[b] = 0;
    for (int64_t i = 0; i < n; ++i)
        out[i >> 3] |= static_cast<uint8_t>((bits[i] & 1) << (i & 7));
}

void unpack_bits(const uint8_t* bytes, int64_t n_bits, uint8_t* out) {
    for (int64_t i = 0; i < n_bits; ++i)
        out[i] = (bytes[i >> 3] >> (i & 7)) & 1;
}

}  // extern "C"
