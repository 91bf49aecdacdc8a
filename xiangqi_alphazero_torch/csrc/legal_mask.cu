// Legal-move mask for a batch of Xiangqi boards, hand-written for Hopper
// (sm_90a).
//
// Replaces the TPU kernel xiangqi_alphazero_tpu/ops/legal_mask.py::
// legal_mask_pallas (its body _kernel and its XLA precompute
// _precompute_batch). Same function: from int8 boards [B, 90] (codes +-1..7,
// red positive) and int8 sides [B] (+-1) it writes the bool [B, 8100] mask of
// the legal moves of the side to move, bit-identical to the plain PyTorch
// version in engine/env.py::legal_mask.
//
// What bounds it on this card: it reads 91 bytes and writes 8,100 per board,
// and a real position has at most ~120 candidate moves, so it is bound by
// its output bytes: B x 8,191 bytes at 3.35 TB/s (5 us at B = 2048, 40 us at
// B = 16384). At serving's B = 1..8 that is nanoseconds, and the latency of
// one board's chain of dependent steps sets the time.
//
// What the design does about it:
//   - candidates by own piece, not all 8,100 actions: each own piece's
//     destinations come from a table (ops/legal_mask.py::action_constants,
//     built from engine/tables.py: per geometry class and from-square, the
//     destinations and each one's blocker squares as a bit range, so a
//     blocker count is a popcount). The block lists its own pieces'
//     candidates by a scan over the squares and gives each candidate a
//     thread, looping until none is left, so any board (up to 90 own
//     pieces, 90 x 17 candidates) is covered. Every other action is false
//     by construction;
//   - the row is assembled in shared memory, laid out at the global row's
//     alignment: zeroed with 16-byte stores, legal candidates set, then
//     written once with 16-byte stores (4-byte at the ragged ends), so the
//     mask bytes are the only large global traffic;
//   - a grid shaped by the batch: 128-thread blocks with ~9 KB of shared
//     memory, a dozen to an SM, so one board's precompute overlaps other
//     boards' stores at large B; at small B, blocks_per_board blocks split
//     one row (each recomputes the 90-byte precompute) to spread it over
//     SMs. The wrapper computes the plan (ops/legal_mask.py::launch_plan);
//   - a short chain per board: warp 0 takes three squares a lane and
//     derives by ballots the occupancy (in rank and file order, so a
//     between-count is a popcount), the king and the 12 enemy attacker
//     slots in ascending square order (2 rooks, 2 cannons, the enemy king,
//     2 horses, 5 pawns), and the candidate counts; after one barrier each
//     thread starts the table load of its candidate, which arrives while
//     warp 0 marks, per square, which slot lines and horse legs it lies on
//     and warps 1-2 decide the king's 4 possible steps (12 slots x 4
//     squares, a thread each). A candidate's king-safety test is then ~20
//     bit operations on those per-square bits.
// Everything is integer arithmetic, so the result is exact by construction.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kSq = 90;
constexpr int kActions = kSq * kSq;
constexpr int kThreads = 128;
constexpr int kCap = 17;                 // table entries per (class, from)
constexpr int kMinBlocks = 12;           // blocks resident per SM (caps registers)
constexpr int kRowBuf = 8112;            // 12 lead bytes + 8100, in 16-byte units
constexpr unsigned kFull = 0xffffffffu;

// ballot masks over the squares, 3 words each
enum { kOcc, kOccF, kOwn, kKing, kEKing, kRook, kCannon, kHorse, kPawn, kMasks };

// screen count that makes each ray slot an attacker: 2 rooks, 2 cannons,
// the enemy king ("flying general")
__constant__ int kRayWant[5] = {0, 0, 1, 1, 0};

struct Board {
  uint32_t m[kMasks][3];
  // per square: bits 0-4 "strictly between ray slot j and the king",
  // bits 8-9 "the leg of horse slot h toward the king", bits 16-27 "holds
  // attacker slot j" (0-4 rays, 5-6 horses, 7-11 pawns)
  uint32_t sq_bits[96];
  // ray slots: bits 0-4 aligned with the king; 8-12 / 16-20 / 24-28 their
  // screen count equals / is one above / is one below the count that
  // attacks
  uint32_t ray_flags;
  // bits 0-1 horse slot a horse move from the king, 8-9 its leg empty,
  // 16-20 pawn slot touching the king
  uint32_t near_flags;
  int pref[96];             // candidates up to each square, inclusive, within its 32
  int warp_total[3];        // candidates of squares 0-31, 32-63, 64-95
  int slot[12];             // attacker slot squares, -1 where the board has none
  int k;                    // the first own king, -1 without one
  int8_t sq[96];
  uint8_t unsafe_sq[96];    // squares next to the king that it may not step to
};

__device__ __forceinline__ int file_major(int x) { return (x % 9) * 10 + x / 9; }

__device__ __forceinline__ bool aligned(int x, int y) {
  return (x / 9 == y / 9) != (x % 9 == y % 9);
}

// z strictly between x and y on a rank or a file (BTW in engine/tables.py)
__device__ __forceinline__ bool between(int x, int y, int z) {
  int xr = x / 9, xc = x % 9, yr = y / 9, yc = y % 9, zr = z / 9, zc = z % 9;
  if (xr == yr) return zr == xr && zc > min(xc, yc) && zc < max(xc, yc);
  if (xc == yc) return zc == xc && zr > min(xr, yr) && zr < max(xr, yr);
  return false;
}

// set bits of a 96-bit mask below bit n (0 <= n <= 96)
__device__ __forceinline__ int popc_below(const uint32_t* m, int n) {
  int c = 0;
#pragma unroll
  for (int w = 0; w < 3; ++w) {
    int k = n - 32 * w;
    uint32_t keep = k >= 32 ? kFull : (k <= 0 ? 0u : (1u << k) - 1u);
    c += __popc(m[w] & keep);
  }
  return c;
}

// set bits of a 96-bit mask in [lo, hi)
__device__ __forceinline__ int popc_range(const uint32_t* m, int lo, int hi) {
  return hi > lo ? popc_below(m, hi) - popc_below(m, lo) : 0;
}

// occupied squares strictly between x and y on a rank or a file
__device__ __forceinline__ int count_between(const Board& P, int x, int y) {
  if (x / 9 == y / 9) return popc_range(P.m[kOcc], min(x, y) + 1, max(x, y));
  if (x % 9 == y % 9) {
    int fx = file_major(x), fy = file_major(y);
    return popc_range(P.m[kOccF], min(fx, fy) + 1, max(fx, fy));
  }
  return 0;
}

// position of the n-th (0-based) set bit of x; x has more than n set bits
__device__ __forceinline__ int select32(uint32_t x, int n) {
  int pos = 0;
#pragma unroll
  for (int sh = 16; sh > 0; sh >>= 1) {
    int c = __popc(x & ((1u << sh) - 1u));
    if (n >= c) {
      n -= c;
      x >>= sh;
      pos += sh;
    }
  }
  return pos;
}

// square of the n-th (0-based) set bit of a 96-bit mask, or -1
__device__ __forceinline__ int nth_square(const uint32_t* m, int n) {
#pragma unroll
  for (int w = 0; w < 3; ++w) {
    int c = __popc(m[w]);
    if (n < c) return 32 * w + select32(m[w], n);
    n -= c;
  }
  return -1;
}

// horse at x attacks y (HORSE_PAIR), and its leg square (KLEG)
__device__ __forceinline__ bool horse_pair(int x, int y) {
  int adr = abs(y / 9 - x / 9), adc = abs(y % 9 - x % 9);
  return (adr == 2 && adc == 1) || (adr == 1 && adc == 2);
}

__device__ __forceinline__ int horse_leg(int x, int y) {
  int dr = y / 9 - x / 9, dc = y % 9 - x % 9;
  return abs(dr) == 2 ? x + (dr / 2) * 9 : x + dc / 2;
}

// a pawn of side index e (0 red, advancing up) at s attacks y (PAWN_ATK)
__device__ __forceinline__ bool pawn_attacks(int e, int s, int y) {
  int fwd = e == 0 ? 1 : -1;
  int sr = s / 9, sc = s % 9, yr = y / 9, yc = y % 9;
  if (yr == sr + fwd && yc == sc) return true;
  bool crossed = e == 0 ? sr >= 5 : sr <= 4;
  return crossed && yr == sr && abs(yc - sc) == 1;
}

// attacker slot j (0-1 rooks, 2-3 cannons, 4 enemy king, 5-6 horses,
// 7-11 pawns): the ballot mask it is taken from and its rank in it
__device__ __forceinline__ int slot_mask(int j) {
  return j < 2 ? kRook : j < 4 ? kCannon : j == 4 ? kEKing : j < 7 ? kHorse : kPawn;
}

__device__ __forceinline__ int slot_rank(int j) {
  return j < 2 ? j : j < 4 ? j - 2 : j == 4 ? 0 : j < 7 ? j - 5 : j - 7;
}

// the geometry class of an own piece (ops/legal_mask.py CLASSES)
__device__ __forceinline__ int piece_class(int kind, int si) {
  switch (kind) {
    case 1: return si;
    case 2: return 2 + si;
    case 3: return 4 + si;
    case 7: return 6 + si;
    case 4: return 8;
    default: return 9;   // rook or cannon
  }
}

// square and entry index of candidate i (0 <= i < total): a binary search
// over the per-square running counts
__device__ __forceinline__ int2 locate(const Board& P, int i) {
  const int t0 = P.warp_total[0], t1 = t0 + P.warp_total[1];
  int lo = 0, hi = 95;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const int g = P.pref[mid] + (mid >= 64 ? t1 : (mid >= 32 ? t0 : 0));
    if (g > i) hi = mid; else lo = mid + 1;
  }
  const int q = lo, qm = q - 1;
  const int excl = q == 0 ? 0 : P.pref[qm] + (qm >= 64 ? t1 : (qm >= 32 ? t0 : 0));
  return make_int2(q, i - excl);
}

__global__ void __launch_bounds__(kThreads, kMinBlocks) legal_mask_by_piece(
    const int8_t* __restrict__ boards, const int8_t* __restrict__ sides,
    const uint32_t* __restrict__ cand, const unsigned long long* __restrict__ ncand,
    uint8_t* __restrict__ out, int blocks_per_board, int chunk) {
  __shared__ Board P;
  __shared__ __align__(16) uint8_t row[kRowBuf];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x / blocks_per_board;
  const int lo = (blockIdx.x % blocks_per_board) * chunk;
  const int hi = min(lo + chunk, kActions);
  const size_t g = (size_t)b * kActions + lo;   // first output byte of the block
  const int off = (int)(g & 15);                 // row[off + i] <-> out[g + i]
  const int s = sides[b];
  const int si = s < 0 ? 1 : 0;                  // side index of the side to move

  // ---- phase A: all warps zero the row; warp 0 takes three squares a
  // lane (q = lane + 32 w): ballots, the candidates of an own piece whose
  // actions reach [lo, hi) summed over each 32 squares, then the king and
  // the attacker slots --------------------------------------------------
  const int nvec = (off + (hi - lo) + 15) >> 4;
  for (int v = tid; v < nvec; v += kThreads)
    reinterpret_cast<uint4*>(row)[v] = make_uint4(0, 0, 0, 0);
  if (warp == 0) {
    int pw[3], pfw[3];
    unsigned long long counts[3];   // 5 bits per class
#pragma unroll
    for (int w = 0; w < 3; ++w) {
      const int q = lane + 32 * w;
      pw[w] = q < kSq ? boards[(size_t)b * kSq + q] : 0;
      // file-major order: bit c * 10 + r is square r * 9 + c
      pfw[w] = q < kSq ? boards[(size_t)b * kSq + (q % 10) * 9 + q / 10] : 0;
      counts[w] = q < kSq ? ncand[q] : 0ull;
    }
#pragma unroll
    for (int w = 0; w < 3; ++w) {
      const int q = lane + 32 * w, p = pw[w];
      P.sq[q] = (int8_t)p;
      P.unsafe_sq[q] = 0;
      P.sq_bits[q] = 0;
      const unsigned occ = __ballot_sync(kFull, p != 0);
      const unsigned occ_f = __ballot_sync(kFull, pfw[w] != 0);
      const unsigned own = __ballot_sync(kFull, p * s > 0);
      const unsigned king = __ballot_sync(kFull, p == s);
      const unsigned eking = __ballot_sync(kFull, p == -s);
      const unsigned rook = __ballot_sync(kFull, p == -5 * s);
      const unsigned cannon = __ballot_sync(kFull, p == -6 * s);
      const unsigned horse = __ballot_sync(kFull, p == -4 * s);
      const unsigned pawn = __ballot_sync(kFull, p == -7 * s);
      if (lane == 0) {
        P.m[kOcc][w] = occ;
        P.m[kOccF][w] = occ_f;
        P.m[kOwn][w] = own;
        P.m[kKing][w] = king;
        P.m[kEKing][w] = eking;
        P.m[kRook][w] = rook;
        P.m[kCannon][w] = cannon;
        P.m[kHorse][w] = horse;
        P.m[kPawn][w] = pawn;
      }
      const int kind = p * s;
      int incl = kind > 0 && q >= lo / kSq && q <= (hi - 1) / kSq
                     ? (int)(counts[w] >> (5 * piece_class(kind, si))) & 31
                     : 0;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(kFull, incl, d);
        if (lane >= d) incl += y;
      }
      P.pref[q] = incl;
      if (lane == 31) P.warp_total[w] = incl;
    }
    __syncwarp();
    if (lane < 12) P.slot[lane] = nth_square(P.m[slot_mask(lane)], slot_rank(lane));
    if (lane == 12) P.k = nth_square(P.m[kKing], 0);
    if (lane == 13) {
      P.ray_flags = 0;
      P.near_flags = 0;
    }
  }
  __syncthreads();

  const int k0 = P.k;
  const bool has_king = k0 >= 0;
  const int k = has_king ? k0 : 0;
  const int ei = 1 - si;                         // enemy side index
  const int n_cand = has_king ? P.warp_total[0] + P.warp_total[1] + P.warp_total[2] : 0;

  // ---- phase B: this thread's first candidate's table entry is loaded
  // now, to arrive while the slots and king-step verdicts are computed ---
  int f0 = 0;
  uint32_t e0 = 0;
  if (tid < n_cand) {
    const int2 fl = locate(P, tid);
    f0 = fl.x;
    e0 = cand[(piece_class(P.sq[f0] * s, si) * kSq + f0) * kCap + fl.y];
  }
  if (tid < 12 && has_king) {
    // attacker slot j against the king where it stands (warp 0)
    const int j = tid, x = P.slot[j];
    if (x >= 0) {
      atomicOr(&P.sq_bits[x], 1u << (16 + j));
      if (j < 5) {
        if (aligned(x, k)) {
          const int c = count_between(P, x, k), want = kRayWant[j];
          atomicOr(&P.ray_flags, (1u << j) | (unsigned)(c == want) << (8 + j) |
                                     (unsigned)(c == want + 1) << (16 + j) |
                                     (unsigned)(c == want - 1) << (24 + j));
          const int step = x / 9 == k / 9 ? (k > x ? 1 : -1) : (k > x ? 9 : -9);
          for (int z = x + step; z != k; z += step) atomicOr(&P.sq_bits[z], 1u << j);
        }
      } else if (j < 7) {
        const int h = j - 5;
        if (horse_pair(x, k)) {
          const int leg = horse_leg(x, k);
          atomicOr(&P.near_flags, (1u << h) | (unsigned)(P.sq[leg] == 0) << (8 + h));
          atomicOr(&P.sq_bits[leg], 1u << (8 + h));
        }
      } else if (pawn_attacks(ei, x, k)) {
        atomicOr(&P.near_flags, 1u << (16 + j - 7));
      }
    }
  } else if (tid >= 32 && tid < 32 + 12 * 4 && has_king) {
    // is the king's orthogonal neighbour pj (its only possible steps)
    // attacked by slot j once the king has left k? (warps 1-2,
    // slot-major, so a warp's threads mostly share a slot type)
    const int j = (tid - 32) >> 2, d = (tid - 32) & 3;
    const int kr = k / 9, kc = k % 9;
    const bool on_board = d == 0 ? kc < 8 : d == 1 ? kc > 0 : d == 2 ? kr < 9 : kr > 0;
    const int pj = k + (d == 0 ? 1 : d == 1 ? -1 : d == 2 ? 9 : -9);
    const int x = on_board ? P.slot[j] : -1;
    bool att = false;
    if (x >= 0 && x != pj) {
      if (j < 5) {
        att = aligned(x, pj) &&
              count_between(P, x, pj) - between(x, pj, k) == kRayWant[j];
      } else if (j < 7) {
        if (horse_pair(x, pj)) {
          const int leg = horse_leg(x, pj);
          att = leg != pj && (leg == k || P.sq[leg] == 0);
        }
      } else {
        att = pawn_attacks(ei, x, pj);
      }
    }
    if (att) P.unsafe_sq[pj] = 1;
  }
  __syncthreads();

  // ---- phase C: one thread per candidate -------------------------------
  const uint32_t rf = P.ray_flags, nf = P.near_flags;
  for (int i = tid; i < n_cand; i += kThreads) {
    int f = f0;
    uint32_t e = e0;
    if (i != tid) {   // past the first 128 candidates (boards no game reaches)
      const int2 fl = locate(P, i);
      f = fl.x;
      e = cand[(piece_class(P.sq[f] * s, si) * kSq + f) * kCap + fl.y];
    }
    const int kind = P.sq[f] * s;
    const int t = e & 0x7f, a = f * kSq + t;
    if (a < lo || a >= hi) continue;
    const int pt = P.sq[t];
    const int spt = pt * s;
    if (spt > 0) continue;   // own piece on the destination
    const int nb = popc_range(P.m[(e >> 24) & 1 ? kOccF : kOcc], (e >> 8) & 0x7f,
                              (e >> 16) & 0x7f);
    const bool pseudo =
        kind == 6 ? (nb == 0 && pt == 0) || (nb == 1 && spt < 0) : nb == 0;
    if (!pseudo) continue;
    bool unsafe;
    if (f == k) {
      unsafe = P.unsafe_sq[t];
    } else {
      // the slots that attack the king after the move: the same test as
      // the plain version's slot deltas, as bit operations per slot
      const uint32_t uf = P.sq_bits[f], ut = P.sq_bits[t];
      const uint32_t held = ut >> 16;             // slots captured on t
      const uint32_t bf = uf & 31, bt = pt != 0 ? 0u : ut & 31;
      const uint32_t rays = rf & ~held &
          (((rf >> 8) & ~(bf ^ bt)) | ((rf >> 16) & bf & ~bt) | ((rf >> 24) & bt & ~bf));
      const uint32_t horses = nf & ~(held >> 5) & ~(ut >> 8) & ((uf >> 8) | (nf >> 8));
      const uint32_t pawns = (nf >> 16) & ~(held >> 7);
      unsafe = ((rays & 31) | (horses & 3) | (pawns & 31)) != 0;
    }
    if (!unsafe) row[off + a - lo] = 1;
  }
  __syncthreads();

  // ---- phase D: write the row, 16 bytes a store where aligned ----------
  // g and the block's end are multiples of 4 (8100 = 4 x 2025, chunk is a
  // multiple of 16), so the ragged head and tail are whole 4-byte words.
  uint8_t* dst = out + g;
  const int nbytes = hi - lo;
  const int head = (16 - off) & 15;
  const int nv = (nbytes - head) >> 4;
  const int tail = nbytes - head - 16 * nv;
  if (tid < head / 4)
    reinterpret_cast<uint32_t*>(dst)[tid] =
        reinterpret_cast<const uint32_t*>(row + off)[tid];
  const uint4* src = reinterpret_cast<const uint4*>(row + off + head);
  uint4* dst16 = reinterpret_cast<uint4*>(dst + head);
  for (int v = tid; v < nv; v += kThreads) dst16[v] = src[v];
  if (tid < tail / 4)
    reinterpret_cast<uint32_t*>(dst + head + 16 * nv)[tid] =
        reinterpret_cast<const uint32_t*>(row + off + head + 16 * nv)[tid];
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int xq_legal_mask(const void* boards, const void* sides,
                             const void* cand, const void* ncand, void* out,
                             int batch, int blocks_per_board, int chunk,
                             void* stream) {
  if (batch <= 0) return 0;
  legal_mask_by_piece<<<batch * blocks_per_board, kThreads, 0,
                        (cudaStream_t)stream>>>(
      (const int8_t*)boards, (const int8_t*)sides, (const uint32_t*)cand,
      (const unsigned long long*)ncand, (uint8_t*)out, blocks_per_board, chunk);
  return (int)cudaGetLastError();
}
