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
// What bounds it on this card: the kernel reads B x 91 bytes and writes
// B x 8100, and does a few hundred integer operations per action, so it is
// bound by its output bytes (B x 8191 B at 3.35 TB/s). At serving's batch of
// 1..8 boards that is nanoseconds, and the launch itself sets the time.
//
// What the design does about it. The TPU kernel spent bf16 one-hot matmuls
// on every table lookup because its matrix unit beats its gathers; here a
// lookup in shared memory is the natural form, and the whole function is ONE
// launch with nothing written to device memory but the mask:
//   - one thread block per board; the board (90 bytes) goes to shared memory;
//   - phase 1, warp 0: ballots over the 90 squares find the own king and the
//     enemy attacker slots in ascending square order (2 rooks, 2 cannons, the
//     enemy king, 2 horses, 5 pawns); lanes then compute each slot's ray
//     between-count to the king, horse leg and pawn reach, and the safety of
//     the 9 palace squares for king moves (the content of _precompute_batch);
//   - phase 2, all threads: neighbouring threads take neighbouring actions,
//     test pseudo-legality from a per-action flag word and blocker-square list
//     (built once from engine/tables.py, so the rules live in one place), then
//     the king-safety test by the move's (from, to) deltas on each slot, and
//     write one byte each.
// Everything is integer arithmetic, so the result is exact by construction.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kSq = 90;
constexpr int kActions = kSq * kSq;
constexpr int kMaxBlock = 8;   // blocker squares per action (a full file)
constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

// Per-action flag bits; ops/legal_mask.py builds the table with this layout.
constexpr unsigned kKing0 = 1u << 0, kKing1 = 1u << 1;
constexpr unsigned kAdv0 = 1u << 2, kAdv1 = 1u << 3;
constexpr unsigned kEle0 = 1u << 4, kEle1 = 1u << 5;
constexpr unsigned kPawn0 = 1u << 6, kPawn1 = 1u << 7;
constexpr unsigned kHorse = 1u << 8, kAligned = 1u << 9;

// screen count that makes each ray slot an attacker: 2 rooks, 2 cannons,
// the enemy king ("flying general")
__constant__ int kRayWant[5] = {0, 0, 1, 1, 0};

struct Board {
  int8_t sq[96];
  uint8_t unsafe_sq[kSq];   // king-move destinations that are attacked
  int ray_s[5], cnt0[5];
  bool ray_pre[5];          // slot valid and aligned with the king
  int hs_i[2], hs_leg[2], hs_locc[2];
  bool hs_geom[2];          // slot valid and a horse move from the king
  int pw_i[5];
  bool pw_pre[5];           // slot valid and the pawn reaches the king
  int k, has_king;
};

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

// occupied squares strictly between x and y, not counting square `skip`
__device__ int count_between(const int8_t* sq, int x, int y, int skip) {
  int xr = x / 9, xc = x % 9, yr = y / 9, yc = y % 9, n = 0;
  if (xr == yr) {
    for (int c = min(xc, yc) + 1; c < max(xc, yc); ++c) {
      int z = xr * 9 + c;
      n += (sq[z] != 0 && z != skip);
    }
  } else if (xc == yc) {
    for (int r = min(xr, yr) + 1; r < max(xr, yr); ++r) {
      int z = r * 9 + xc;
      n += (sq[z] != 0 && z != skip);
    }
  }
  return n;
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

// index of the n-th (0-based) set bit of a 96-bit square mask, or -1
__device__ int nth_square(const unsigned m[3], int n) {
  for (int w = 0; w < 3; ++w) {
    int c = __popc(m[w]);
    if (n < c) {
      unsigned x = m[w];
      for (int i = 0; i < n; ++i) x &= x - 1;
      return 32 * w + __ffs(x) - 1;
    }
    n -= c;
  }
  return -1;
}

__global__ void __launch_bounds__(kThreads) legal_mask_kernel(
    const int8_t* __restrict__ boards, const int8_t* __restrict__ sides,
    const uint16_t* __restrict__ flags, const uint8_t* __restrict__ nblock,
    const uint8_t* __restrict__ block, uint8_t* __restrict__ out) {
  __shared__ Board P;
  const int b = blockIdx.x;
  const int s = sides[b];
  const int si = s < 0 ? 1 : 0;   // side index of the side to move
  for (int i = threadIdx.x; i < kSq; i += kThreads) {
    P.sq[i] = boards[(size_t)b * kSq + i];
    P.unsafe_sq[i] = 0;
  }
  __syncthreads();

  // ---- phase 1: per-board precompute, warp 0 ---------------------------
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    unsigned m_king[3], m_ek[3], m_rk[3], m_cn[3], m_hs[3], m_pw[3];
    for (int w = 0; w < 3; ++w) {
      int q = lane + 32 * w;
      int p = q < kSq ? P.sq[q] : 0;
      m_king[w] = __ballot_sync(kFull, p == s);
      m_ek[w] = __ballot_sync(kFull, p == -s);
      m_rk[w] = __ballot_sync(kFull, p == -5 * s);
      m_cn[w] = __ballot_sync(kFull, p == -6 * s);
      m_hs[w] = __ballot_sync(kFull, p == -4 * s);
      m_pw[w] = __ballot_sync(kFull, p == -7 * s);
    }
    // every lane derives the same slots from the ballots
    int k = nth_square(m_king, 0);
    const int has_king = k >= 0;
    k = has_king ? k : 0;
    int ray_s[5], hs_i[2], pw_i[5];
    bool ray_v[5], hs_v[2], pw_v[5];
    for (int j = 0; j < 2; ++j) {
      ray_s[j] = nth_square(m_rk, j);
      ray_s[2 + j] = nth_square(m_cn, j);
      hs_i[j] = nth_square(m_hs, j);
    }
    ray_s[4] = nth_square(m_ek, 0);
    for (int j = 0; j < 5; ++j) pw_i[j] = nth_square(m_pw, j);
    for (int j = 0; j < 5; ++j) {
      ray_v[j] = ray_s[j] >= 0;
      ray_s[j] = max(ray_s[j], 0);
      pw_v[j] = pw_i[j] >= 0;
      pw_i[j] = max(pw_i[j], 0);
    }
    for (int j = 0; j < 2; ++j) {
      hs_v[j] = hs_i[j] >= 0;
      hs_i[j] = max(hs_i[j], 0);
    }
    const int ei = 1 - si;   // enemy side index

    if (lane < 5) {          // ray slots against the king where it stands
      int x = ray_s[lane];
      P.ray_s[lane] = x;
      P.ray_pre[lane] = ray_v[lane] && aligned(x, k);
      P.cnt0[lane] = count_between(P.sq, x, k, -1);
    } else if (lane < 7) {   // horses
      int h = lane - 5, x = hs_i[h];
      bool geom = hs_v[h] && horse_pair(x, k);
      int leg = geom ? horse_leg(x, k) : 0;
      P.hs_i[h] = x;
      P.hs_geom[h] = geom;
      P.hs_leg[h] = leg;
      P.hs_locc[h] = P.sq[leg] != 0;
    } else if (lane < 12) {  // pawns: contact attacks ignore the move
      int p = lane - 7;
      P.pw_i[p] = pw_i[p];
      P.pw_pre[p] = pw_v[p] && pawn_attacks(ei, pw_i[p], k);
    } else if (lane < 21) {  // king moves: is palace square pj attacked?
      int j = lane - 12;
      int pj = ((si ? 7 : 0) + j / 3) * 9 + 3 + j % 3;
      bool unsafe = false;
      for (int r = 0; r < 5; ++r) {
        int x = ray_s[r];
        if (ray_v[r] && aligned(x, pj) && pj != x) {
          // the king has left k
          unsafe |= count_between(P.sq, x, pj, k) == kRayWant[r];
        }
      }
      for (int h = 0; h < 2; ++h) {
        int x = hs_i[h];
        if (hs_v[h] && horse_pair(x, pj) && pj != x) {
          int leg = horse_leg(x, pj);
          int locc = leg == pj ? 1 : (leg == k ? 0 : P.sq[leg] != 0);
          unsafe |= locc == 0;
        }
      }
      for (int p = 0; p < 5; ++p) {
        unsafe |= pw_v[p] && pawn_attacks(ei, pw_i[p], pj) && pj != pw_i[p];
      }
      P.unsafe_sq[pj] = unsafe;
    }
    if (lane == 0) {
      P.k = k;
      P.has_king = has_king;
    }
  }
  __syncthreads();

  // ---- phase 2: one action per thread, strided --------------------------
  const int k = P.k;
  const bool has_king = P.has_king;
  const unsigned king_bit = si ? kKing1 : kKing0;
  const unsigned adv_bit = si ? kAdv1 : kAdv0;
  const unsigned ele_bit = si ? kEle1 : kEle0;
  const unsigned pawn_bit = si ? kPawn1 : kPawn0;
  uint8_t* row = out + (size_t)b * kActions;
  for (int a = threadIdx.x; a < kActions; a += kThreads) {
    bool ok = false;
    const int f = a / kSq, t = a - f * kSq;
    const int kind = P.sq[f] * s;   // own piece kinds are positive
    const int pt = P.sq[t];
    const int spt = pt * s;
    if (has_king && kind > 0 && spt <= 0) {
      const unsigned fl = flags[a];
      bool pseudo;
      if (kind == 1) {
        pseudo = fl & king_bit;
      } else if (kind == 2) {
        pseudo = fl & adv_bit;
      } else if (kind == 7) {
        pseudo = fl & pawn_bit;
      } else {
        const unsigned geom =
            kind == 3 ? ele_bit : (kind == 4 ? kHorse : kAligned);
        pseudo = false;
        if (fl & geom) {
          int nb = 0;
          const int n = nblock[a];
          for (int i = 0; i < n; ++i) nb += P.sq[block[a * kMaxBlock + i]] != 0;
          pseudo = kind == 6 ? (nb == 0 && pt == 0) || (nb == 1 && spt < 0)
                             : nb == 0;
        }
      }
      if (pseudo) {
        bool unsafe = false;
        if (f == k) {
          unsafe = P.unsafe_sq[t];
        } else {
          const bool occ_t = pt != 0;
          for (int j = 0; j < 5; ++j) {
            const int x = P.ray_s[j];
            if (P.ray_pre[j] && t != x) {
              int c = P.cnt0[j] - between(x, k, f) + (occ_t ? 0 : between(x, k, t));
              unsafe |= c == kRayWant[j];
            }
          }
          for (int h = 0; h < 2; ++h) {
            const int leg = P.hs_leg[h];
            if (P.hs_geom[h] && t != P.hs_i[h]) {
              int locc = t == leg ? 1 : (f == leg ? 0 : P.hs_locc[h]);
              unsafe |= locc == 0;
            }
          }
          for (int p = 0; p < 5; ++p) unsafe |= P.pw_pre[p] && t != P.pw_i[p];
        }
        ok = !unsafe;
      }
    }
    row[a] = ok;
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int xq_legal_mask(const void* boards, const void* sides,
                             const void* flags, const void* nblock,
                             const void* block, void* out, int batch,
                             void* stream) {
  if (batch <= 0) return 0;
  legal_mask_kernel<<<batch, kThreads, 0, (cudaStream_t)stream>>>(
      (const int8_t*)boards, (const int8_t*)sides, (const uint16_t*)flags,
      (const uint8_t*)nblock, (const uint8_t*)block, (uint8_t*)out);
  return (int)cudaGetLastError();
}
