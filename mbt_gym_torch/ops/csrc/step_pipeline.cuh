// Warp-specialised step pipeline of the episode kernels: a CTA's producer
// warps compute the draws of the steps ahead, and have the bulk-copy engine
// stage the depth-table rows those steps read (and, in noise mode, the
// injected draws), into a ring of shared-memory slots; its consumer warps
// run the env step, one thread per env with the state in registers,
// reading both from shared memory.  Used by K1 and K2 (as_episode.cu), K5
// (det_rollout.cu), K6 (oe_episode.cu) and K8 (cj_episode.cu).
//
// Why: the draws are counter-based, keyed by (seed, env) at counter (step,
// draw) (draws.cuh), so they do not depend on the state; in noise mode they
// are plain loads.  The table row a step reads is known before the step
// runs.  One thread per env leaves a card with 16,384 envs at one warp per
// scheduler, where nothing hides the Philox chains, the libm calls and the
// table row's L2 trip on the state chain.  Here the draws of a slot's C
// steps are spread over P producer warps per CTA, and the consumers' chain
// per step is a shared-memory load, the bookkeeping and, where the fill
// probabilities are not staged, two expf.
//
// The wide shape: where one thread per env already keeps the card's
// schedulers busy (from step_pipeline.py's wide_min_envs on), the
// producers only add work.  A geometry with P = 0 has no ring and no
// mbarrier: a CTA of kWideEnvs threads, each stepping one env and drawing
// its own draws inline (draws.cuh) in the same operation order, so the bits
// are the pipeline's.  K1, K2, K6 and K8 have both paths as two
// instantiations (kWide); the wrapper's geometry picks one.  K5 has the
// pipeline alone.
//
// The ring: R slots, each holding the inputs of C consecutive steps:
//   draws  [C][channels][E + 4] floats (five channels on limit dynamics, the
//          midprice normal alone on speed dynamics), then
//   table  [table_rows][padded(C * row_floats)] floats: for each table, the
//          rows of the slot's C steps, which lie one after the other in
//          global memory (none when the table is read from global memory
//          instead).
// A run of floats in global memory (a table's rows for a slot; in noise
// mode, one step's channel for the CTA's envs) is copied whole by one bulk
// copy of the 16-byte granules that hold it, whatever its alignment: it
// lands `shift` floats (its address mod 16, in floats) into its slot row,
// which is why a row has 3 floats more room than it holds.  A granule that
// holds one valid byte lies in a mapped page, so the copy cannot fault; the
// extra floats are never read.  The injected noise has kNoiseChannels
// channels per step: (T, 5, N) for the limit kernels and K5, whose speed
// dynamics read channel 4, and (T, N) for K6.  K5's general process kinds
// (kMapped) stage 8 channels on the market-making dynamics (the five, then
// the two exogenous normals and the second midprice normal) and 2 on speed
// dynamics (the midprice normal, the second midprice normal); their noise
// has a runtime channel count and places, given by a noise map: a type
// with channels() (per step), of(c) (the noise channel ring channel c
// holds; a ring channel the config does not use takes any valid one, never
// read) and extras() (native mode draws the extra normals).
//
// One full and one empty mbarrier per slot.  Each producer warp arrives on
// `full` once its lanes have written their draws (and one lane has
// registered the slot's bulk-copy bytes, which complete on it too); each
// consumer warp arrives on `empty` once its lanes have read the slot.  No
// CTA-wide barrier runs inside the step loop.
//
// The layout is mirrored by mbt_gym_torch/ops/step_pipeline.py, which
// chooses the geometry; ring_bytes() here must equal its smem_bytes.
#pragma once

#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

#include "draws.cuh"

namespace mbt {

// Mirrors PipelineGeometry in mbt_gym_torch/ops/step_pipeline.py (ctypes).
struct PipeGeometry {
  int envs;        // E: envs per CTA, 32 per consumer warp
  int producers;   // P: producer warps per CTA, a multiple of E / 32; 0: the wide shape
  int chunk;       // C: steps per slot
  int slots;       // R: slots in the ring (0 in the wide shape)
  int channels;    // draw channels per step: 5 (limit) or 1 (speed)
  int table_rows;  // tables a step reads a row of (K5: four; K8: two)
  int row_floats;  // floats from one step's row to the next in such a table
  int staged;      // 1: the rows are staged in the ring; 0: read from global memory
  int smem_bytes;  // the CTA's dynamic shared memory
};

constexpr int kMaxPipeThreads = 512;
constexpr int kWideEnvs = 128;  // a wide-shape CTA's threads, one env each

__host__ __device__ inline bool is_wide(const PipeGeometry& g) { return g.producers == 0; }

// Slot rows have room for a run that starts up to 3 floats into a granule.
__host__ __device__ inline int padded(int floats) { return (floats + 3 + 3) & ~3; }
__host__ __device__ inline int draw_stride(const PipeGeometry& g) { return g.envs + 4; }
__host__ __device__ inline int table_stride(const PipeGeometry& g) { return padded(g.chunk * g.row_floats); }

__host__ __device__ inline int ring_slot_floats(const PipeGeometry& g) {
  return g.chunk * g.channels * draw_stride(g) + (g.staged ? g.table_rows * table_stride(g) : 0);
}

__host__ __device__ inline int ring_bytes(const PipeGeometry& g) {
  return 16 * g.slots + 4 * g.slots * ring_slot_floats(g);
}

// The invariants every pipeline kernel assumes of its geometry (the
// wrapper's pipeline_geometry keeps them): whole warps of envs, producers a
// multiple of the env groups, the CTA within kMaxPipeThreads, `channels`
// draw channels, and the shared memory ring_bytes() gives; in the wide
// shape, kWideEnvs envs and no ring.
inline bool pipe_shape_ok(const PipeGeometry& g, int channels) {
  if (g.channels != channels || g.smem_bytes != ring_bytes(g)) return false;
  if (is_wide(g)) return g.envs == kWideEnvs && g.slots == 0 && !g.staged;
  const int groups = g.envs / 32;
  return g.envs >= 32 && g.envs % 32 == 0 && g.producers >= groups && g.producers % groups == 0 &&
         g.envs + 32 * g.producers <= kMaxPipeThreads && g.chunk >= 1 && g.slots >= 1;
}

// Launches a pipeline kernel over n envs: one CTA per E envs, E + 32 P
// threads (E in the wide shape), the ring's dynamic shared memory.
template <class... Params, class... Args>
cudaError_t launch_pipeline(void (*kernel)(Params...), const PipeGeometry& g, int n, cudaStream_t s,
                            const Args&... args) {
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, g.smem_bytes);
  if (err != cudaSuccess) return err;
  kernel<<<(n + g.envs - 1) / g.envs, g.envs + 32 * g.producers, g.smem_bytes, s>>>(args...);
  return cudaSuccess;
}

// Where a run of floats starting at `p` lands in its slot row: its offset
// in floats from the 16-byte granule that holds it.
__device__ __forceinline__ int granule_shift(const float* p) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) >> 2) & 3);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// A wait this long (~17 s at the H100's clock) is a barrier that will never
// complete: the kernel traps, so the launch fails with an error instead of
// holding the card.
constexpr long long kMbarTimeoutCycles = 1LL << 35;

// Returns once the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  const long long start = clock64();
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (!done && clock64() - start > kMbarTimeoutCycles) __trap();
  } while (!done);
}

// One contiguous global -> shared copy by the bulk-copy engine, completing
// `bytes` (a multiple of 16, both addresses 16-byte aligned) on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes), "r"(smem_addr(bar))
               : "memory");
}

// The 16-byte granules holding `floats` floats from `src`: their first
// address (in `start`) and their bytes.
__device__ __forceinline__ uint32_t granule_bytes(const float* src, int floats, const float** start) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(src);
  const uintptr_t lo = a & ~static_cast<uintptr_t>(15);
  *start = reinterpret_cast<const float*>(lo);
  return static_cast<uint32_t>(((a + 4 * static_cast<uintptr_t>(floats) + 15) & ~static_cast<uintptr_t>(15)) - lo);
}

// The noise map of the kernels whose channels are fixed (noise_channel).
struct FixedChannels {};

// The channel of the injected noise that ring channel c of a step holds: a
// one-channel kernel takes the midprice normal, channel 4 of (T, 5, N)
// noise or the only one of (T, N).
template <int kChannels, int kNoiseChannels>
__host__ __device__ constexpr int noise_channel(int c) {
  return kNoiseChannels == 1 ? 0 : kChannels == 1 ? 4 : c;
}

class StepRing {
 public:
  // Carves the ring out of the CTA's dynamic shared memory and initialises
  // its barriers; every thread of the CTA calls it once, before its role.
  __device__ StepRing(const PipeGeometry& g, unsigned char* smem)
      : g_(g),
        full_(reinterpret_cast<uint64_t*>(smem)),
        empty_(reinterpret_cast<uint64_t*>(smem) + g.slots),
        base_(reinterpret_cast<float*>(smem + 16 * g.slots)),
        slot_floats_(ring_slot_floats(g)) {
    if (threadIdx.x == 0) {
      for (int s = 0; s < g.slots; ++s) {
        mbar_init(full_ + s, g.producers);
        mbar_init(empty_ + s, g.envs >> 5);
      }
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
  }

  __device__ int consumer_warps() const { return g_.envs >> 5; }
  __device__ float* draws(int slot) const { return base_ + slot * slot_floats_; }
  __device__ float* table(int slot) const { return draws(slot) + g_.chunk * g_.channels * draw_stride(g_); }

  // Consumer side, run by each consumer thread over `run_steps` steps:
  // `slot_steps(slot, c0, steps)` steps the env through episode steps c0 ..
  // c0 + steps - 1, whose inputs slot `slot` holds, once they have landed;
  // the slot is handed back once every lane of the warp has read it.
  template <class SlotSteps>
  __device__ void consume(int run_steps, SlotSteps slot_steps) const {
    int slot = 0;
    uint32_t phase = 0;
    for (int c0 = 0; c0 < run_steps; c0 += g_.chunk) {
      mbar_wait(full_ + slot, phase);
      slot_steps(slot, c0, min(g_.chunk, run_steps - c0));
      __syncwarp();
      if ((threadIdx.x & 31) == 0) mbar_arrive(empty_ + slot);
      if (++slot == g_.slots) {
        slot = 0;
        phase ^= 1u;
      }
    }
  }

  // Producer side, run by the CTA's producer warps (warp index `pw` among
  // them) for the CTA's envs env0 .. env0 + E - 1 over `run_steps` steps.
  // Native mode: producer warp pw computes the draws (draws.cuh) of the 32
  // envs of group pw % (E / 32) at the steps j = pw / (E / 32),
  // + P / (E / 32), ... of each slot; kChannels 5 (philox_draws) or 1 (the
  // midprice normal).  Noise mode: each step's channel runs for the CTA's
  // envs are bulk copies, from noise of kNoiseChannels channels a step.
  // `table_row(r, step)` points at a step's row of table r; the rows of
  // consecutive steps follow each other, row_floats apart, so a slot's rows
  // of one table are one bulk copy.  Producer warp 0 registers and starts
  // the slot's bulk copies.
  // With a noise map (K5's general kinds, kChannels 8 or 2) `map` places
  // the noise channels and says whether native mode draws the extra
  // normals (philox_extra_normals).
  template <bool kNoise, int kChannels, int kNoiseChannels = 5, class TableRow, class NoiseMap = FixedChannels>
  __device__ void produce(int pw, int run_steps, int env0, int n, uint32_t seed, const float* __restrict__ noise,
                          TableRow table_row, const NoiseMap& map = NoiseMap{}) const {
    constexpr bool kMapped = !std::is_same<NoiseMap, FixedChannels>::value;
    const int groups = g_.envs >> 5;
    const int lane = threadIdx.x & 31;
    const int e_local = (pw % groups) * 32 + lane;
    const int env = env0 + e_local;
    const int first = pw / groups, stride = g_.producers / groups;
    const int valid = min(g_.envs, n - env0);
    const int ds = draw_stride(g_), ts = table_stride(g_);
    constexpr int draw_runs = kNoise ? kChannels : 0;  // bulk copies per step
    const int table_runs = g_.staged ? g_.table_rows : 0;  // bulk copies per slot
    int slot = 0;
    uint32_t phase = 0;
    for (int c0 = 0; c0 < run_steps; c0 += g_.chunk) {
      const int steps = min(g_.chunk, run_steps - c0);
      mbar_wait(empty_ + slot, phase ^ 1u);
      float* d = draws(slot);
      float* t = table(slot);
      const int runs = table_runs + steps * draw_runs;
      if (pw == 0 && runs > 0) {
        // run k: the slot's rows of table k, then step (k - table_runs) /
        // draw_runs's draw channels
        auto run = [&](int k, float** dst, int* floats) {
          if constexpr (kNoise) {
            if (k >= table_runs) {
              const int j = (k - table_runs) / kChannels, c = k - table_runs - j * kChannels;
              *dst = d + (j * kChannels + c) * ds;
              *floats = valid;
              if constexpr (kMapped) {
                return noise + (static_cast<size_t>(c0 + j) * map.channels() + map.of(c)) * n + env0;
              } else {
                const int channel = noise_channel<kChannels, kNoiseChannels>(c);
                return noise + (static_cast<size_t>(c0 + j) * kNoiseChannels + channel) * n + env0;
              }
            }
          }
          *dst = t + k * ts;
          *floats = steps * g_.row_floats;
          return table_row(k, c0);
        };
        if (lane == 0) {
          uint32_t total = 0;
          for (int k = 0; k < runs; ++k) {
            float* dst;
            int floats;
            const float* start;
            const float* src = run(k, &dst, &floats);
            total += granule_bytes(src, floats, &start);
          }
          mbar_expect_tx(full_ + slot, total);
        }
        __syncwarp();
        for (int k = lane; k < runs; k += 32) {
          float* dst;
          int floats;
          const float* start;
          const float* src = run(k, &dst, &floats);
          const uint32_t bytes = granule_bytes(src, floats, &start);
          bulk_copy(dst, start, bytes, full_ + slot);
        }
      }
      if constexpr (!kNoise) {
        for (int j = first; env < n && j < steps; j += stride) {
          float* out = d + j * kChannels * ds + e_local;
          const int i = c0 + j;
          if constexpr (kChannels == 5) {
            const Draws v = philox_draws(seed, static_cast<uint32_t>(env), static_cast<uint32_t>(i));
            out[0] = v.u_ab;
            out[ds] = v.u_aa;
            out[2 * ds] = v.u_fb;
            out[3 * ds] = v.u_fa;
            out[4 * ds] = v.normal;
          } else if constexpr (kChannels == 8) {
            const uint4 a = philox4x32_10(make_uint4(static_cast<uint32_t>(i), 0u, 0u, 0u),
                                          make_uint2(seed, static_cast<uint32_t>(env)));
            out[0] = uniform24(a.x);
            out[ds] = uniform24(a.y);
            out[2 * ds] = uniform24(a.z);
            out[3 * ds] = uniform24(a.w);
            if (map.extras()) {
              const ExtraNormals e = philox_extra_normals(seed, static_cast<uint32_t>(env), static_cast<uint32_t>(i));
              out[4 * ds] = e.normal;
              out[5 * ds] = e.exo_bid;
              out[6 * ds] = e.exo_ask;
              out[7 * ds] = e.mid2;
            } else {
              out[4 * ds] = philox_normal(seed, static_cast<uint32_t>(env), static_cast<uint32_t>(i));
            }
          } else if constexpr (kChannels == 2) {
            if (map.extras()) {
              const ExtraNormals e = philox_extra_normals(seed, static_cast<uint32_t>(env), static_cast<uint32_t>(i));
              out[0] = e.normal;
              out[ds] = e.mid2;
            } else {
              out[0] = philox_normal(seed, static_cast<uint32_t>(env), static_cast<uint32_t>(i));
            }
          } else {
            out[0] = philox_normal(seed, static_cast<uint32_t>(env), static_cast<uint32_t>(i));
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(full_ + slot);
      if (++slot == g_.slots) {
        slot = 0;
        phase ^= 1u;
      }
    }
  }

 private:
  const PipeGeometry g_;
  uint64_t* full_;
  uint64_t* empty_;
  float* base_;
  int slot_floats_;
};

// A consumer thread's view of one slot's draws: slot step j (episode step
// i), channel c of its env.  In noise mode each (step, channel) run landed
// shifted by its granule offset (see above); native draws are unshifted.
template <bool kNoise, int kChannels, int kNoiseChannels = 5>
struct SlotDraws {
  const float* slot;   // draws(slot) + the thread's env within the CTA
  const float* noise;  // noise + env0 (noise mode)
  int n;
  int stride;          // draw_stride
  __device__ float at(int j, int i, int c) const {
    int shift = 0;
    if constexpr (kNoise) {
      const int channel = noise_channel<kChannels, kNoiseChannels>(c);
      shift = granule_shift(noise + (static_cast<size_t>(i) * kNoiseChannels + channel) * n);
    }
    return slot[(j * kChannels + c) * stride + shift];
  }
  __device__ Draws limit(int j, int i) const {
    Draws d;
    d.u_ab = at(j, i, 0);
    d.u_aa = at(j, i, 1);
    d.u_fb = at(j, i, 2);
    d.u_fa = at(j, i, 3);
    d.normal = at(j, i, 4);
    return d;
  }
};

// SlotDraws for a ring whose noise channels a noise map places.
template <bool kNoise, int kChannels, class NoiseMap>
struct MappedSlotDraws {
  const float* slot;
  const float* noise;
  int n;
  int stride;
  NoiseMap map;
  __device__ float at(int j, int i, int c) const {
    int shift = 0;
    if constexpr (kNoise) {
      shift = granule_shift(noise + (static_cast<size_t>(i) * map.channels() + map.of(c)) * n);
    }
    return slot[(j * kChannels + c) * stride + shift];
  }
  __device__ Draws limit(int j, int i) const {
    Draws d;
    d.u_ab = at(j, i, 0);
    d.u_aa = at(j, i, 1);
    d.u_fb = at(j, i, 2);
    d.u_fa = at(j, i, 3);
    d.normal = at(j, i, 4);
    return d;
  }
};

}  // namespace mbt
