// Lookup kernels for Hopper (sm_90a): every algorithm's lookup, k-replica
// walk (unbounded and bounded), epoch diffs and bounded-load chain walk.
//
// Replaces every configuration of the TPU engine kernel
// src/repro/kernels/engine.py::_engine_pallas (body _engine_kernel_factory,
// per-algorithm bodies dispatched by algo_body, modes by _mode_outputs):
//   memento_*         <- memento_body + dense_body        (K1a)
//   memento_packed_*  <- memento_body + packed_reader     (K1b)
//   anchor_packed_*   <- anchor_body over narrowed A/K    (K1b)
//   memento_compact_lookup, memento_compact_replica
//                     <- memento_body + compact_reader    (K1g; replica_body
//                        over it at k > 1 and bounded)
//   anchor_*  <- anchor_body                 (K1c)
//   dx_*      <- dx_body                     (K1d)
//   power_*   <- primitives.power32          (K1e)
//   jump_*    <- primitives.jump32           (K1f)
// (DxHash, JumpHash and PowerHash images have one layout: their packed
// images run the dense entries.)  For each algorithm the modes
//   {algo}_lookup        k = 1 lookup
//   {algo}_diff          k = 1 lookup under two epochs + moved    (K1i)
//   {algo}_replica       replica_body, k slots, optionally bounded (K1h)
//   {algo}_replica_diff  replica_body under two epochs, k > 1     (K1i)
//   {algo}_walk          chain_walk_body, one bounded-load step    (K1j)
// (the compact table serves only the lookup and the replica walk, as in
// the reference).
//
// What bounds them on the card.  A key costs hashes (murmur3 mixes),
// integer modulos and, for Memento and Jump, ~ln(n) jump32 steps with a
// correctly rounded f32 divide each: on a stable state that integer issue
// is the bound.  Once many buckets are removed, a key also follows chains
// of dependent gathers into tables of a few MB to tens of MB (Memento's
// repl 4-8 MB at n = 10^6, its packed slot table 33.5 MB after a 90 %
// removal, Anchor's A and K 32 MB at a = 4*10^6, Dx's bitmap 0.5 MB): ~10
// reads a key for Memento at 90 % removed, each a 32-byte L2 sector for
// 4 useful bytes.  There the loads a SM keeps in flight bound the time,
// not the bytes of the tables (chip_smoke.py's bound_ms counts operations
// and each table byte once, so it sits below what the card can reach):
// a replica walk that loaded 40 % fewer sectors with half the warps a SM
// ran twice as long.  DxHash is the slowest: after a 90 % removal at
// capacity factor 4 a key needs ~a/w = 40 probes, and one thread a key
// leaves a warp waiting for its slowest key (~4 x the mean).  A replica
// set costs about k lookups (plus one per rejected candidate), a walk step
// one lookup per probe.  One thread a walk lane leaves ~73 % of a warp's
// lane slots with no load outstanding at 90 % removed (a model, PERF.md),
// yet walks that kept every lane loading ran slower (the designs below),
// so lane use is not what binds the one-shot walk (what does is open).
//
// Design: one thread per key with per-thread loops.  The Pallas kernel runs
// lane-synchronous masked while_loops over (8, 128) key blocks, so a block
// settles when its slowest lane does; here a warp waits only for its own
// 32 keys, and every lane's result is the same either way.  Tables are read
// straight from global memory (through L2).  Each algorithm's per-key logic
// is one __device__ function, wrapped in a small operand struct, and every
// mode's kernel is a template over that struct, so the modes of one
// algorithm cannot disagree about a placement.  A replica walk keeps its
// chosen slots in the lane's own output row and compares each candidate
// with them there, so k has no limit.  The DxHash entries are the
// exceptions: when ceil(a/w) >= 8 a key's probes are spread over G lanes
// (dx_group_bucket; G the largest power of two <= ceil(a/w) / 4, at most
// 32, for dx_lookup, for each lookup of a dx_replica set, whose group runs
// the key's whole salted walk, and for each lookup of a dx_walk step, whose
// group runs the lane's whole chain; half that for dx_diff, from the epoch
// with more probes, whose group probes both epochs), so a warp waits for
// the slowest of 32 / G keys and each round tests G probes of a key; a key
// then loads ~G/2 bitmap words past its hit, and these G balanced the two
// in sweeps (PERF.md).  dx_replica_diff runs each epoch's rows as
// dx_replica does, at its own G, once the epoch with more probes takes 8
// lanes or more, and then compares the rows in a pass of its own
// (dx_replica_diff_group).  DxHash's probe remainder divides by a fixed a
// with multiplies (fastmod).
//
// PowerHash does what a key needs only once a launch: its top level L and
// mask are the host's (Power), and every salt's inner mix of hash2 is
// a table the compiler builds into constant memory (kPowerMix), so a draw
// is one fmix32.  A diff of two epochs of one L runs both lookups on one
// top sequence and one descent (power_pair_diff_kernel).
//
// An AnchorHash diff of two epochs of one a (anchor_replica_diff,
// anchor_packed_diff, anchor_packed_replica_diff) first checks on the card
// whether their removal stacks nest: anchor_nest_kernel, a grid over both
// epochs' A and K after a memset; for a <= 2^15 (every int8 and int16
// table) anchor_nest_part_kernel, one bucket a thread and no memset, its
// blocks' sums reduced by anchor_nest_verdict_kernel.  The pair kernel, a
// programmatic dependent launch (its launch overlaps the check), then
// looks both epochs up on one walk through the deeper epoch's tables, of
// that epoch's width (anchor_nested), or, where they do not nest, walks
// each epoch.  Epochs of any widths; the dense anchor_diff keeps
// diff_kernel.
//
// Memento's Alg. 4 reads repl(d) once: the inner loop's last read is the
// next pass's (memento_from), one round trip a pass fewer than the
// reference's loop.  A k = 1 Memento diff of two epochs of one n runs both
// lookups of a key through memento_pair: one jump32 for both, both first
// reads in flight together (memento_pair_diff_kernel).
//
// The salted replica walks.  Each tests a candidate with row_takes and
// fills a row whose salts ran out with row_keep_first, so they share the
// rules of replica_body; each exists for the work it lets a thread or a
// group share:
//   replica_row              one lookup a try, one thread a key: every
//                            {algo}_replica but dx_replica at G >= 2, dense,
//                            packed and compact, and the replica diffs
//                            whose epochs share nothing (DxHash below G =
//                            8, JumpHash, PowerHash, AnchorHash epochs
//                            that do not nest or are of two a, Memento at
//                            two n).  Unbounded and bounded are two
//                            instances, each with the loop that ran
//                            fastest for it.
//   replica_pair_row         the Memento replica diffs of one n: both
//                            epochs' rows on one salt walk, each salt's
//                            jump32 run once for both, both epochs' first
//                            reads in flight together.
//   anchor_pair_row          the AnchorHash replica diffs, dense and
//                            packed, whose epochs nest (one removal stack
//                            a prefix of the other's, which the check
//                            finds on the card): both rows on one salt
//                            walk, each salt looked up in both epochs by
//                            one walk through the deeper epoch's tables
//                            (anchor_nested).  Epochs that do not nest
//                            take each epoch's replica_row in the same
//                            kernel.
//   dx_group_replica_kernel  dx_replica at G >= 2: replica_row's walk run
//                            by a lane group (and each epoch of
//                            dx_replica_diff at G >= 8 whose own G is).
//
// Memento's table is read through a reader functor (DenseRepl, PackedRepl<T>,
// CompactRepl) and AnchorHash's A/K through their element type T, so the
// packed layouts reuse every mode's kernel template unchanged.  A packed
// read loads the bitmap word and the first probe slot's two words at once
// (PackedRepl), and every probe slot loads both its words before comparing
// (probe_from): a removed bucket's read is one round trip where it was
// three (word, then slot_b, then slot_c).  Narrow slots and A/K words are
// signed: they are sign-extended to int32 before any compare, so EMPTY (-1)
// and TOMBSTONE (-2) stay negative.  A probe stops after as many slots as
// the table has: the reference's loop has no bound and relies on an empty
// slot, which every valid image has, so the bound changes no answer and
// keeps a broken table from hanging the card.  The `width` argument of a
// packed entry (1, 2 or 4 bytes) picks the template instance; each epoch of
// a diff has its own.
//
// Designs that lost to these on the card and were deleted (PERF.md; the
// figures below from an NVIDIA H100 80GB HBM3 at 700.00 W): a
// lookup kernel with several keys in flight a thread (every count tried);
// a persistent memento_packed_replica kernel with the packed bitmap staged
// in shared memory (one 1024-thread block a SM, half the warps: x2.06
// one-shot); replica slots held in registers (+4 to +8 % stable); the
// fixed-divisor remainder as a 64 x 64 high product (+2.5 % stable);
// G = ceil(a/w) rounded up to a power of two (G = 32 one-shot: +2.4 %);
// dx_diff at dx_lookup's G (+10 % at ceil(a/w) = 8); and for
// memento_packed_walk a flattened walk, a persistent grid whose lanes each
// issue one round trip an iteration and take the next index from a counter
// (one atomic an index: x1.54 one-shot; 32 indices a warp an atomic:
// +8.6 %; those 32 staged with their first jump32 run together: +5.3 %
// one-shot, +19 to +52 % elsewhere), and a first lookup a thread with the
// lanes still at or over the cap queued in shared memory for full warps
// (-26 % stable, +35 % one-shot).  For the Memento replica diff: the pair
// walk at any n with salt 0 taken apart from the loop (34-40 registers:
// +4.9 % int32 stable -> one-shot, +9.6 % dense, +3.7 % at n - 1 against
// the two replica_rows it replaced); the pair capped at 8 blocks a SM by
// __launch_bounds__ (int16 -34.5 % where the uncapped pair ran -36.5 %);
// both epochs' chains advanced in lockstep, both reads of a step in
// flight (int8 -17.6 % against -25.6 %, int32 -7.8 % against -9.3 %).
// dx_replica at G/2 and 2G (one-shot k = 3 -4.8 and +3.6 %, bounded -20.2
// and -29.0 %, where G ran -6.0 and -34.5 %).  dx_walk at G/2 (one-shot
// 0.496 ms where G ran 0.391).  For the Memento replica sets, a walk that
// took two salts of a key a round while two slots were open, in one thread:
// both jump32 chains stepped in one loop until the longer ended (28-32
// registers; memento_replica stable +14.8 %, packed stable +21.9 %,
// one-shot +0.9 to +2.1 %: a pair cost twice its longer chain), stepped
// together only while both ran (stable +20 %), or one after the other,
// both first reads and both load words in flight (stable +4.8 %,
// one-shot -0.2 %); and the two salts on two lanes, the first accepting
// from shuffles (4-17 % slower than the one-thread pair).  For replica_row,
// one loop over the salts in both modes with salt 0 in it (bounded -5 to
// -12 %, but unbounded stable +1.0 to +4.2 % and int16 and int8 bounded +1
// to +2.7 %), and a loop a slot in both modes (packed one-shot bounded
// +1.9 %).  For anchor_one (every AnchorHash entry; anchor_lookup at a =
// 4*10^6 against the loop below): K[h] loaded with every A[h], so a chain
// step is one round trip (stable +64.5 %, one-shot +24.7 %: a K word more
// every pass, and the stable state's K, idle before, now shares the L2
// with A); K[h] loaded with A[h] only once a chain is followed (one-shot
// +0.7 %); the pass's last read of A kept as the next pass's A[b] with the
// start by fastmod (one-shot +0.1 %, packed int16 -5.4 % and int8 -9.7 %:
// no gain where the time is).  For CompactRepl (memento_compact_lookup and
// memento_compact_replica), a reader that loaded the aligned group of g
// slots holding a probe slot, one vector load a table, and went on through
// the group in registers: fewer round trips a read (a model, PERF.md), yet
// slower the wider the load (one-shot k = 3 against this reader: g = 2
// +52 %, g = 4 +78.9 %, g = 8 +148 %; lookup one-shot at g = 4 +73.8 %),
// and its first form, whose slot loop kept the group in local memory, x3.8.
// For dx_replica_diff, both epochs' rows on one salt walk of a lane group,
// each candidate drawn once and tested in both bitmaps (stable -> one-shot
// at G = 8 +9.4 % against one thread a key; +9.7 % with one ballot a round
// telling the warp which epochs it still probes; +11.9 % with the rows
// tested over the group's lanes; G/2 slower still), and the split of
// dx_replica_diff_group at G = 2 in both epochs (+24.4 %).  For
// memento_walk (stable and after 1024 removals at cap 2, one-shot 90 %
// removed at cap 14, half the lanes pending), a walk that looked up an open
// lane's next steps on its warp's idle lanes (with w lanes open, min(S, 32
// / w) steps each a round, the lowest hitting step taken by ballot and
// shuffles; 28 registers): S = 2 stable -15.7 %, 1024 removals -16.0 %,
// one-shot +5.1 %; S = 4 -23.0, -23.7, +7.6 %; S = 32 -16.5, -16.4, +18.0 %:
// fewer rounds pay where a lookup is jump32 alone, and the extra lookups
// cost more where lookups follow chains.  For anchor_replica, the lookups
// of the next min(k - j, F) salts advanced together, one read a chain a
// step, bounded with their load words read together (F = 3, 40 registers:
// stable k = 3 +5.0 %, one-shot k = 3 +2.4 %, bounded k = 2 +22.2 %; F = 2,
// 30 registers: +6.8, +1.9, +5.2 %), and F = 3 with A and K read under an
// L2 evict_last policy, keys and rows streamed (within 1.1 % of F = 3):
// AnchorHash's sets ran at one rate of random words whatever their shape.
// For jump_walk (stable w = 10^6 cap 2, one-shot cap 14, half the lanes
// pending), memento_walk's look-ahead above (S = 2, 4, 32 steps: 28, 31,
// 30 registers): S = 4 stable -18.2 %, but one-shot -1.1 %, and S = 2 and
// 32 slower than S = 4 (one-shot +4.1 and +8.0 %): a one-shot warp's tail
// has ~3 open lanes, most of which stop at their next step, and a round of
// 8-12 lookups waits for a longer jump32 loop than a round of 3.  Measured
// beside it and not kept here: the lanes of a block still open after
// their first lookup queued in shared memory and stepped in full warps,
// two barriers a round (256 lanes a block: stable -23.7 %, one-shot
// -17.2 %; 512 and 1024 slower, 128 even with 256), which ROADMAP.md's
// redesign queue holds for jump_walk and power_walk.  For anchor_walk (a =
// 4*10^6 one-shot 90 % removed, cap 14, half and every lane pending), that
// queue (24-26 registers, one barrier a round): 256 lanes a block +31.7 and
// +33.7 %, 128 lanes +15.8 and +19.2 %, 512 lanes +49.5 and +51.3 %, and
// anchor_packed_walk on it +13.3 % int16, +3.0 % int8: an AnchorHash step
// is a chain of ~20 dependent loads, so each round waits for its slowest
// lane and a block holds its slots longer, where idle lanes cost little
// issue (walk_kernel at 128 and 64 lanes a block, a yardstick, ran -4.2
// and -5.3 %).  For power_lookup and
// power_diff (stable n = 10^6, one-shot 10^5, against the top level made
// once a launch), a key's draws after its first, or its descent alone,
// spread over its warp's idle lanes: with o keys open, 32 / o lanes each
// (rounded down to a power of two, restaged through shared memory as the
// groups grow), the lowest draw that ends something taken by a ballot and
// a shuffle (27 registers): lookups +42 to +57 %, diffs +35 to +62 %.  A
// round compiled to about 100 instructions where one level costs about
// 21, and a warp's deepest key descends only ~5.4 levels.  For the check of
// the packed AnchorHash diffs (alone, int16 a = 32000 / int8 a = 100;
// against the parted check with dependent launches, 0.004170 / 0.002582
// ms): anchor_nest_kernel's grid, 16 buckets a thread one after another
// after a memset (0.010467 / 0.005346 ms), the same grid at one bucket a
// thread over up to 132 SMs (0.006009 / 0.005416), one block of 1024
// threads reading every bucket, 8 buckets' words loaded before any compare
// (0.010401 / 0.003056: one SM's loads in flight set it), and the parted
// check launched without the dependent attribute (0.004966 / 0.002582; the
// int16 k = 1 diff 7.2 % slower).
//
// Arithmetic: uint32 words wrap mod 2^32 and % is unsigned, as in the
// reference.  The jump32 step uses __fdiv_rn / __fadd_rn / __fmul_rn, so
// it stays correctly rounded whatever the compiler flags.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kGolden32 = 0x9E3779B1u;
constexpr uint32_t kC1 = 0x85EBCA6Bu;
constexpr uint32_t kC2 = 0xC2B2AE35u;
constexpr uint32_t kStepSalt = 0x2545F491u;
constexpr uint32_t kPowerSalt = 0x506F5748u;  // repro_torch.core.power
constexpr int32_t kPowerTryCap = 64;
constexpr int32_t kReplicaSaltCap = 4096;  // repro_torch.core.protocol.REPLICA_SALT_CAP
constexpr int kThreads = 256;
constexpr int32_t kEmpty = -1;  // repro_torch.core.packing.EMPTY

__host__ __device__ __forceinline__ constexpr uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= kC1;
  h ^= h >> 13;
  h *= kC2;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ uint32_t hash2(uint32_t key, uint32_t seed) {
  return fmix32(key ^ fmix32(seed * kGolden32 + 1u));
}

// b <- j; j <- floor((b + 1) / r) with r = (u24 + 1) * 2^-24, while j < n.
__device__ __forceinline__ int32_t jump32(uint32_t key, int32_t n) {
  const float nf = __int2float_rn(n);
  int32_t b = 0;
  float j = 0.0f;
  for (uint32_t i = 0; j < nf; ++i) {
    b = __float2int_rz(j);  // j is a whole number below n: exact
    const uint32_t u = fmix32(key ^ (i * kGolden32 + kStepSalt)) >> 8;
    const float r = __fmul_rn(__fadd_rn(__uint2float_rn(u), 1.0f),
                              5.9604644775390625e-08f);  // 2^-24
    const float jn = floorf(__fdiv_rn(__fadd_rn(__int2float_rn(b), 1.0f), r));
    j = fminf(jn, nf);
  }
  return b;
}

// Paper Alg. 4 over a table reader, from b and its read c = repl(b):
// repl(b) = |W_b| if b was removed, else -1.  A chain is followed only while
// repl(d) >= w_b.  The inner loop's last read, repl(d) < w_b, is the next
// outer read (b = d): it is taken as c, not read again.
template <class Read>
__device__ __forceinline__ int32_t memento_from(uint32_t key, const Read& repl, int32_t b,
                                                int32_t c) {
  while (c >= 0) {
    const int32_t wb = c > 0 ? c : 1;  // a valid image never holds 0
    int32_t d = static_cast<int32_t>(hash2(key, static_cast<uint32_t>(b)) %
                                     static_cast<uint32_t>(wb));
    while ((c = repl(d)) >= wb) d = c;
    b = d;
  }
  return b;
}

template <class Read>
__device__ __forceinline__ int32_t memento_one(uint32_t key, const Read& repl, int32_t n) {
  const int32_t b = jump32(key, n);
  return memento_from(key, repl, b, repl(b));
}

// Each reader's repl(i) is fetch(i), which only issues loads, then
// finish(i, f), which waits for them: a caller can issue two reads before
// it waits for either (replica_pair_row).
// The dense table: one int32 word per bucket.
struct DenseRepl {
  const int32_t* repl;
  struct Fetch {
    int32_t v;
  };
  __device__ Fetch fetch(int32_t i) const { return {repl[i]}; }
  __device__ int32_t finish(int32_t, Fetch f) const { return f.v; }
  __device__ int32_t operator()(int32_t i) const { return repl[i]; }
};

// The first slot of bucket i's probe in a table of mask + 1 slots.
__device__ __forceinline__ uint32_t probe_start(int32_t i, uint32_t mask) {
  return fmix32(static_cast<uint32_t>(i) * kGolden32 + 5u) & mask;
}

// repl(i) from an open-addressing table of mask + 1 slots: linear probing
// from probe_start(i) until slot_b holds i (-> slot_c), or a slot ends the
// chain: EMPTY only (kEmptyOnly, the packed layout, whose TOMBSTONEs keep a
// chain going) or any negative slot (the compact table); a bucket not
// found is working (-1).  probe_from starts at slot pos, whose two words
// sb, sc (sign-extended) the caller has loaded; every later slot loads both
// words at once, so a hit costs one round trip, not two (slot_c[pos] is in
// bounds whatever slot_b[pos] holds).
template <class T, bool kEmptyOnly>
__device__ __forceinline__ int32_t probe_from(const T* __restrict__ slot_b,
                                              const T* __restrict__ slot_c, uint32_t mask,
                                              int32_t i, uint32_t pos, int32_t sb, int32_t sc) {
  for (uint32_t s = 0;; ++s) {
    if (sb == i) return sc;
    if ((kEmptyOnly ? sb == kEmpty : sb < 0) || s == mask) return -1;
    pos = (pos + 1u) & mask;
    sb = static_cast<int32_t>(slot_b[pos]);
    sc = static_cast<int32_t>(slot_c[pos]);
  }
}

// The packed layout (K1b): bit i & 31 of state word i >> 5 set means
// working, with no probe; a removed bucket probes its T-wide slots.  The
// first probe slot is loaded together with the bitmap word, before the bit
// says whether it is needed: a removed bucket's read then costs one round
// trip, not two (bitmap word, then slot), and a working one two more loads
// that are never waited for.
template <class T>
struct PackedRepl {
  const uint32_t* state;
  const T* slot_b;
  const T* slot_c;
  uint32_t mask;
  struct Fetch {
    uint32_t word, pos;
    int32_t sb, sc;
  };
  __device__ Fetch fetch(int32_t i) const {
    const uint32_t pos = probe_start(i, mask);
    return {state[i >> 5], pos, static_cast<int32_t>(slot_b[pos]),
            static_cast<int32_t>(slot_c[pos])};
  }
  __device__ int32_t finish(int32_t i, Fetch f) const {
    if ((f.word >> (static_cast<uint32_t>(i) & 31u)) & 1u) return -1;
    return probe_from<T, true>(slot_b, slot_c, mask, i, f.pos, f.sb, f.sc);
  }
  __device__ int32_t operator()(int32_t i) const { return finish(i, fetch(i)); }
};

// The compact table (K1g): every read probes.
struct CompactRepl {
  const int32_t* slot_b;
  const int32_t* slot_c;
  uint32_t mask;
  struct Fetch {
    uint32_t pos;
    int32_t sb, sc;
  };
  __device__ Fetch fetch(int32_t i) const {
    const uint32_t pos = probe_start(i, mask);
    return {pos, slot_b[pos], slot_c[pos]};
  }
  __device__ int32_t finish(int32_t i, Fetch f) const {
    return probe_from<int32_t, false>(slot_b, slot_c, mask, i, f.pos, f.sb, f.sc);
  }
  __device__ int32_t operator()(int32_t i) const { return finish(i, fetch(i)); }
};

// AnchorHash: A[b] = 0 for a working bucket, else the working-set size
// right after b was removed; K[b] the bucket that replaced b.  Start at
// fmix32(key) % a; at a removed bucket draw h = hash2(key, b) % A[b] and
// step back through K while h was removed at or after b (A[h] >= A[b]).
// T is int32 for the dense layout, int8/int16/int32 for the packed one:
// every word is widened to int32 as it is read.
// anchor_step is one pass from removed bucket b (ab = A[b] > 0).
template <class T>
__device__ __forceinline__ int32_t anchor_step(uint32_t key, const T* __restrict__ A,
                                               const T* __restrict__ K, int32_t b, int32_t ab) {
  int32_t h = static_cast<int32_t>(hash2(key, static_cast<uint32_t>(b)) %
                                   static_cast<uint32_t>(ab));
  while (static_cast<int32_t>(A[h]) >= ab) h = K[h];
  return h;
}

template <class T>
__device__ __forceinline__ int32_t anchor_one(uint32_t key, const T* __restrict__ A,
                                              const T* __restrict__ K, int32_t a) {
  int32_t b = static_cast<int32_t>(fmix32(key) % static_cast<uint32_t>(a));
  int32_t ab;
  while ((ab = A[b]) > 0) b = anchor_step(key, A, K, b, ab);
  return b;
}

// Both lookups of `key` under two AnchorHash epochs of one a whose removal
// stacks nest (anchor_nest_kernel says so), on one walk through the deeper
// epoch's A and K.  A removal stamps A[b] with the working count left after
// it and K[b] with the bucket that replaced b, and no later removal changes
// them; so every bucket the shallower epoch removed keeps its A and K in
// the deeper one, stamped at or above n_shallow (the shallower epoch's
// working count), and every other bucket is stamped below it there.  The
// shallower epoch's lookup is then the deeper epoch's walk read with
// "removed" meaning A[b] >= n_shallow: the walk's first bucket stamped
// below n_shallow (`shallow`).  The deeper epoch's lookup goes on from
// there while A[b] > 0 (`deep`, walked only when `want_deep`).  T is the
// deeper epoch's element type; every A word is widened to int32 before it
// is compared with n_shallow, so a negative word stays negative.
template <class T>
__device__ __forceinline__ void anchor_nested(uint32_t key, const T* __restrict__ A,
                                              const T* __restrict__ K, int32_t a,
                                              int32_t n_shallow, bool want_deep,
                                              int32_t& shallow, int32_t& deep) {
  int32_t b = static_cast<int32_t>(fmix32(key) % static_cast<uint32_t>(a));
  int32_t ab = static_cast<int32_t>(A[b]);
  for (; ab >= n_shallow; ab = static_cast<int32_t>(A[b])) b = anchor_step(key, A, K, b, ab);
  shallow = b;
  if (!want_deep) return;
  for (; ab > 0; ab = static_cast<int32_t>(A[b])) b = anchor_step(key, A, K, b, ab);
  deep = b;
}

// x % a for a divisor fixed by the host, by multiplies (Lemire, Kaser and
// Kurz, "Faster Remainder by Direct Computation", 2019): with magic =
// ceil(2^64 / a) (UINT64_MAX / a + 1, which wraps to 0 at a = 1), x % a is
// the high word of ((magic * x) mod 2^64) * a, exact for every 32-bit x and
// a >= 1.  That 96-bit product's high word is taken in 32-bit halves,
// (hi * a + umulhi(lo, a)) >> 32, so no 64 x 64 high product is needed.
__device__ __forceinline__ uint32_t fastmod(uint32_t x, uint64_t magic, uint32_t a) {
  const uint64_t low = magic * x;
  return static_cast<uint32_t>((static_cast<uint64_t>(static_cast<uint32_t>(low >> 32)) * a +
                                __umulhi(static_cast<uint32_t>(low), a)) >> 32);
}

// PowerHash's operands for one n, made once a launch on the host
// (power(n)): L = floor(log2(n - 1)) (0 at n <= 2, where every path below
// 2^L ends at bucket 0) and the top level's mask 2^(L+1) - 1.  n < 2^31
// keeps L <= 30, so every shift below is defined.  operator() is the
// lookup (defined below).
struct Power {
  int32_t n, L;
  uint32_t hi_mask;
  __device__ int32_t operator()(uint32_t key) const;
};

// hash2's inner mix fmix32(seed * kGolden32 + 1) of every PowerHash salt
// kPowerSalt + i, i < 31 * 64: top draw t of level L is i = (L << 6) + t,
// descent level j is i = j << 6.  Built by the compiler into constant
// memory, so a draw is one load, a xor and one fmix32; the loads of a
// launch's top level and of one level are the same for every lane.
struct PowerMixes {
  uint32_t v[31 * 64];
};
constexpr PowerMixes power_mixes() {
  PowerMixes m{};
  for (uint32_t i = 0; i < 31 * 64; ++i) m.v[i] = fmix32((kPowerSalt + i) * kGolden32 + 1u);
  return m;
}
__constant__ PowerMixes kPowerMix = power_mixes();

// hash2(key, kPowerSalt + i), its inner mix read from kPowerMix.
__device__ __forceinline__ uint32_t power_hash(uint32_t key, uint32_t i) {
  return fmix32(key ^ kPowerMix.v[i]);
}

// Top-level draw t of `key`: hash2(key, kPowerSalt + (L << 6) + t) &
// hi_mask; it ends the top level when it is below n.
__device__ __forceinline__ uint32_t power_top(uint32_t key, const Power& p, int32_t t) {
  return power_hash(key, (static_cast<uint32_t>(p.L) << 6) + static_cast<uint32_t>(t)) &
         p.hi_mask;
}

// Descent level j of `key`: hash2(key, kPowerSalt + (j << 6)) & (2^(j+1) -
// 1); the level takes it when it is at least 2^j.  The draws depend on
// (key, j) alone, not on n.
__device__ __forceinline__ uint32_t power_level(uint32_t key, int32_t j) {
  return power_hash(key, static_cast<uint32_t>(j) << 6) & ((2u << j) - 1u);
}

// The descent from level L - 1: the first level j = L-1 .. 0 whose draw is
// at least 2^j, else bucket 0.
__device__ __forceinline__ int32_t power_descent(uint32_t key, int32_t L) {
  for (int32_t j = L - 1; j >= 0; --j) {
    const uint32_t c = power_level(key, j);
    if (c >= (1u << j)) return static_cast<int32_t>(c);
  }
  return 0;
}

// PowerHash level descent, one thread a key.  The top level redraws while
// v >= n, at most kPowerTryCap draws in all, and accepts v in [2^L, n);
// otherwise the key descends.
__device__ __forceinline__ int32_t Power::operator()(uint32_t key) const {
  uint32_t v = power_top(key, *this, 0);
  for (int32_t t = 1; v >= static_cast<uint32_t>(n) && t < kPowerTryCap; ++t)
    v = power_top(key, *this, t);
  if (v < static_cast<uint32_t>(n) && v >= (1u << L)) return static_cast<int32_t>(v);
  return power_descent(key, L);
}

// One epoch's operands per algorithm; operator() is that epoch's lookup.
template <class Read>
struct MementoT {
  Read repl;
  int32_t n;
  __device__ int32_t operator()(uint32_t key) const { return memento_one(key, repl, n); }
};
template <class T>
struct AnchorT {
  const T* A;
  const T* K;
  int32_t a;
  __device__ int32_t operator()(uint32_t key) const { return anchor_one(key, A, K, a); }
};
// DxHash: probe candidate(key, i) = hash2(key, i) % a in the bitmap of
// working buckets (bucket c is bit c & 31 of word c >> 5) for i <
// max_probes, else fallback.
struct Dx {
  const uint32_t* words;
  uint64_t magic;  // fastmod's for a
  int32_t a, max_probes, fallback;
  __device__ uint32_t candidate(uint32_t key, int32_t i) const {
    return fastmod(hash2(key, static_cast<uint32_t>(i)), magic, static_cast<uint32_t>(a));
  }
  __device__ bool working(uint32_t c) const { return (words[c >> 5] >> (c & 31u)) & 1u; }
  __device__ int32_t operator()(uint32_t key) const {
    for (int32_t i = 0; i < max_probes; ++i) {
      const uint32_t c = candidate(key, i);
      if (working(c)) return static_cast<int32_t>(c);
    }
    return fallback;
  }
};
struct Jump {
  int32_t n;
  __device__ int32_t operator()(uint32_t key) const { return jump32(key, n); }
};

template <class Body>
__global__ void lookup_kernel(const uint32_t* __restrict__ keys,
                              int32_t* __restrict__ out, int64_t count, Body body) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < count) out[i] = body(keys[i]);
}

// A DxHash key's probes spread over a group of G lanes (G a power of two,
// 32 / G keys a warp): the bucket of `key` under one epoch.  In round r
// lane l of a group tests probe r * G + l; the group takes the candidate
// of its lowest lane that hit (the smallest probe index that hits: the
// sequential loop's answer, for any G) by a ballot and a shuffle.  The
// warp runs while any of its groups is open, so every lane of the warp
// calls this together; a lane with no key (`live` false) votes no hit, and
// a group that reaches max_probes without a hit returns fallback.  Every
// round begins below max_probes, so `max_probes - base` cannot overflow.
template <int G>
__device__ __forceinline__ int32_t dx_group_bucket(const Dx& dx, uint32_t key, bool live) {
  const uint32_t lane = threadIdx.x & 31u;
  const uint32_t sub = lane & (G - 1u);
  // this group's lanes of the warp (G % 32: no shift by 32 at G = 32)
  const uint32_t group = (G == 32 ? 0xFFFFFFFFu : (1u << (G % 32)) - 1u) << (lane - sub);
  bool open = live;
  int32_t b = dx.fallback;
  for (int32_t base = 0; __any_sync(0xFFFFFFFFu, open); base += G) {
    uint32_t c = 0u;
    const bool hit = open && static_cast<int32_t>(sub) < dx.max_probes - base &&
                     dx.working(c = dx.candidate(key, base + static_cast<int32_t>(sub)));
    const uint32_t votes = __ballot_sync(0xFFFFFFFFu, hit) & group;
    const uint32_t first =
        __shfl_sync(0xFFFFFFFFu, c, votes ? __ffs(votes) - 1 : static_cast<int>(lane));
    if (open && votes) b = static_cast<int32_t>(first);
    if (votes || base >= dx.max_probes - G) open = false;
  }
  return b;
}

// dx_lookup at G lanes a key: lanes past `count` join the group rounds and
// store nothing.
template <int G>
__global__ void dx_group_kernel(const uint32_t* __restrict__ keys,
                                int32_t* __restrict__ out, int64_t count, Dx dx) {
  const int64_t k = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) / G;
  const bool live = k < count;
  const int32_t b = dx_group_bucket<G>(dx, live ? keys[k] : 0u, live);
  if (live && (threadIdx.x & (G - 1u)) == 0) out[k] = b;
}

// dx_diff at G lanes a key: the group probes the old epoch, then the new
// one, and its first lane stores both and whether the key moved.
template <int G>
__global__ void dx_group_diff_kernel(const uint32_t* __restrict__ keys,
                                     int32_t* __restrict__ old_out,
                                     int32_t* __restrict__ new_out,
                                     int32_t* __restrict__ moved, int64_t count, Dx old_dx,
                                     Dx new_dx) {
  const int64_t k = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) / G;
  const bool live = k < count;
  const uint32_t key = live ? keys[k] : 0u;
  const int32_t o = dx_group_bucket<G>(old_dx, key, live);
  const int32_t w = dx_group_bucket<G>(new_dx, key, live);
  if (live && (threadIdx.x & (G - 1u)) == 0) {
    old_out[k] = o;
    new_out[k] = w;
    moved[k] = o != w;
  }
}

// power_diff of two epochs of one top level L: both draw the same top
// sequence, the epoch of the larger n stops at or before the other, and
// the descent's draws depend on the key alone.  So one top sequence runs
// until v < max(n) fixes that epoch's top, then on until v < min(n) (or the
// cap) fixes the other's, and one descent serves whichever epochs descend.
__global__ void power_pair_diff_kernel(const uint32_t* __restrict__ keys,
                                       int32_t* __restrict__ old_out,
                                       int32_t* __restrict__ new_out,
                                       int32_t* __restrict__ moved, int64_t count,
                                       Power po, Power pn) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= count) return;
  const uint32_t key = keys[i];
  const uint32_t hi = static_cast<uint32_t>(po.n > pn.n ? po.n : pn.n);
  const uint32_t lo = static_cast<uint32_t>(po.n > pn.n ? pn.n : po.n);
  uint32_t v = power_top(key, po, 0);
  int32_t t = 1;
  for (; v >= hi && t < kPowerTryCap; ++t) v = power_top(key, po, t);
  const uint32_t vh = v;
  for (; v >= lo && t < kPowerTryCap; ++t) v = power_top(key, po, t);
  const bool top_hi = vh < hi && vh >= (1u << po.L);
  const bool top_lo = v < lo && v >= (1u << po.L);
  const int32_t d = top_hi && top_lo ? 0 : power_descent(key, po.L);
  const int32_t bh = top_hi ? static_cast<int32_t>(vh) : d;
  const int32_t bl = top_lo ? static_cast<int32_t>(v) : d;
  const int32_t o = po.n > pn.n ? bh : bl;
  const int32_t b = po.n > pn.n ? bl : bh;
  old_out[i] = o;
  new_out[i] = b;
  moved[i] = o != b;
}

// The two epochs of a diff may differ in type (packed slots of another
// width after a snapshot grew the table).
template <class Old, class New>
__global__ void diff_kernel(const uint32_t* __restrict__ keys,
                            int32_t* __restrict__ old_out,
                            int32_t* __restrict__ new_out,
                            int32_t* __restrict__ moved, int64_t count,
                            Old old_body, New new_body) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= count) return;
  const uint32_t key = keys[i];
  const int32_t o = old_body(key);
  const int32_t w = new_body(key);
  old_out[i] = o;
  new_out[i] = w;
  moved[i] = o != w;
}

// Whether a replica walk's row, holding j slots, takes cand as its next:
// cand is no earlier slot's bucket and, bounded (load != nullptr), its load
// is under the cap.  At j = 0 unbounded it takes any cand, as slot 0 takes
// the key's plain lookup `first` untested.
__device__ __forceinline__ bool row_takes(const int32_t* row, int32_t j, int32_t cand,
                                          const int32_t* __restrict__ load, int32_t cap) {
  bool bad = load != nullptr && load[cand] >= cap;
  for (int32_t i = 0; i < j && !bad; ++i) bad = row[i] == cand;
  return !bad;
}

// A row whose salts ran out with j < k slots taken keeps `first` in the
// rest.
__device__ __forceinline__ void row_keep_first(int32_t* row, int32_t j, int32_t k,
                                               int32_t first) {
  for (; j < k; ++j) row[j] = first;
}

// replica_body for one key into row[0, k): the salted walk.  The candidate
// at salt 0 is the plain lookup `first`, at salt s >= 1 the lookup of
// hash2(key, s); every try takes the next salt, whatever it accepted, and
// a row whose salts pass kReplicaSaltCap keeps `first` in its open slots.
// Unbounded, slot 0 is `first`, taken untested; bounded, salt 0 is tested
// against the cap as every later salt is, so salt 0 is taken apart from the
// loop in both.  The two modes are two instances (kBounded, picked by the
// launch), and each keeps the loop that ran fastest for it on the card
// (PERF.md): one loop a slot unbounded, one loop over the salts bounded.
template <bool kBounded, class Body>
__device__ void replica_row(uint32_t key, int32_t* row, int32_t k, const Body& body,
                            const int32_t* __restrict__ load, int32_t cap) {
  const int32_t first = body(key);
  int32_t j = 0, salt = 1;
  if (!kBounded || load[first] < cap) row[j++] = first;
  if (kBounded) {
    for (; j < k && salt <= kReplicaSaltCap; ++salt) {
      const int32_t cand = body(hash2(key, static_cast<uint32_t>(salt)));
      if (row_takes(row, j, cand, load, cap)) row[j++] = cand;
    }
    row_keep_first(row, j, k, first);
    return;
  }
  for (; j < k; ++j) {
    int32_t cand;
    do {
      if (salt > kReplicaSaltCap) {
        row_keep_first(row, j, k, first);
        return;
      }
      cand = body(hash2(key, static_cast<uint32_t>(salt++)));
    } while (!row_takes(row, j, cand, nullptr, cap));
    row[j] = cand;
  }
}

template <bool kBounded, class Body>
__global__ void replica_kernel(const uint32_t* __restrict__ keys, int32_t* out,
                               int64_t count, int32_t k, const int32_t* __restrict__ load,
                               int32_t cap, Body body) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < count) replica_row<kBounded>(keys[i], out + i * k, k, body, load, cap);
}

// dx_replica at G lanes a key: replica_row's salted walk, run by the group.
// Each candidate is the group's dx_group_bucket of hash2(key, salt) (at
// salt 0 the key's own bucket `first`), so every lane of the group holds
// the same one.  The group's first lane tests it with row_takes, stores it,
// and gives its verdict to the group by a shuffle, so j and `open` agree
// over the group.  The warp loops while any of its groups has a slot open,
// so salt steps in every lane alike; a lane past `count` or of a finished
// group joins every collective with `open` false.
template <int G>
__global__ void dx_group_replica_kernel(const uint32_t* __restrict__ keys, int32_t* out,
                                        int64_t count, int32_t k,
                                        const int32_t* __restrict__ load, int32_t cap,
                                        Dx dx) {
  const int64_t q = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) / G;
  const bool live = q < count;
  const uint32_t key = live ? keys[q] : 0u;
  const uint32_t lane = threadIdx.x & 31u;
  const bool lead = (lane & (G - 1u)) == 0;
  int32_t* row = out + (live ? q : 0) * k;
  const int32_t first = dx_group_bucket<G>(dx, key, live);
  int32_t j = 0;
  bool open = live;
  for (int32_t salt = 0; __any_sync(0xFFFFFFFFu, open); ++salt) {
    const int32_t cand =
        salt == 0 ? first : dx_group_bucket<G>(dx, hash2(key, static_cast<uint32_t>(salt)), open);
    int take = 0;
    if (open && lead) {
      take = row_takes(row, j, cand, load, cap);
      if (take) row[j] = cand;
    }
    take = __shfl_sync(0xFFFFFFFFu, take, static_cast<int>(lane & ~(G - 1u)));
    if (open && take) ++j;
    if (open && j < k && salt == kReplicaSaltCap) {  // the salts ran out
      if (lead) row_keep_first(row, j, k, first);
      j = k;
    }
    open = open && j < k;
  }
}

// Whether a diff moved key i's set: any slot differs between its rows.
__device__ __forceinline__ int32_t row_moved(const int32_t* o, const int32_t* w, int32_t k) {
  int32_t m = 0;
  for (int32_t j = 0; j < k; ++j) m |= o[j] != w[j];
  return m;
}

template <class Old, class New>
__global__ void replica_diff_kernel(const uint32_t* __restrict__ keys, int32_t* old_out,
                                    int32_t* new_out, int32_t* __restrict__ moved,
                                    int64_t count, int32_t k, Old old_body,
                                    New new_body) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= count) return;
  const uint32_t key = keys[i];
  int32_t* o = old_out + i * k;
  int32_t* w = new_out + i * k;
  replica_row<false>(key, o, k, old_body, nullptr, 0);
  replica_row<false>(key, w, k, new_body, nullptr, 0);
  moved[i] = row_moved(o, w, k);
}

// The moved mask of two epochs' replica sets written by earlier launches.
__global__ void rows_moved_kernel(const int32_t* __restrict__ old_out,
                                  const int32_t* __restrict__ new_out,
                                  int32_t* __restrict__ moved, int64_t count, int32_t k) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < count) moved[i] = row_moved(old_out + i * k, new_out + i * k, k);
}

// Both lookups of one candidate key ck under two Memento epochs of one n,
// for the epochs that want one (go, gn): one jump32 starts both chains,
// and both epochs' first reads are issued before either is waited for.
template <class RO, class RN>
__device__ __forceinline__ void memento_pair(uint32_t ck, const MementoT<RO>& ob,
                                             const MementoT<RN>& nb, bool go, bool gn,
                                             int32_t& co, int32_t& cn) {
  const int32_t b = jump32(ck, ob.n);
  typename RO::Fetch fo{};
  typename RN::Fetch fn{};
  if (go) fo = ob.repl.fetch(b);
  if (gn) fn = nb.repl.fetch(b);
  if (go) co = memento_from(ck, ob.repl, b, ob.repl.finish(b, fo));
  if (gn) cn = memento_from(ck, nb.repl, b, nb.repl.finish(b, fn));
}

// Both Memento epochs' rows of one key on one salt walk, the epochs having
// one n.  Unbounded, replica_row's epoch takes salt s at its (s+1)-th try
// (salt 0 the key itself, slot 0 taken without a test), whatever it
// accepted before: both epochs try the same salts in the same order, each
// until its row is full or the salts run out, so walking them together,
// an epoch leaving the walk when its row is full, gives each epoch
// replica_row's row.  Each salt's candidate key is hashed once and its
// jump32 run once for both epochs.
template <class RO, class RN>
__device__ void replica_pair_row(uint32_t key, int32_t* o, int32_t* w, int32_t k,
                                 const MementoT<RO>& ob, const MementoT<RN>& nb) {
  int32_t jo = 0, jn = 0;
  for (int32_t salt = 0; salt <= kReplicaSaltCap && (jo < k || jn < k); ++salt) {
    const bool go = jo < k, gn = jn < k;
    int32_t co = 0, cn = 0;
    memento_pair(salt == 0 ? key : hash2(key, static_cast<uint32_t>(salt)), ob, nb, go, gn,
                 co, cn);
    if (go && row_takes(o, jo, co, nullptr, 0)) o[jo++] = co;
    if (gn && row_takes(w, jn, cn, nullptr, 0)) w[jn++] = cn;
  }
  row_keep_first(o, jo, k, o[0]);
  row_keep_first(w, jn, k, w[0]);
}

template <class RO, class RN>
__global__ void replica_pair_kernel(const uint32_t* __restrict__ keys, int32_t* old_out,
                                    int32_t* new_out, int32_t* __restrict__ moved,
                                    int64_t count, int32_t k, MementoT<RO> old_body,
                                    MementoT<RN> new_body) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= count) return;
  int32_t* o = old_out + i * k;
  int32_t* w = new_out + i * k;
  replica_pair_row(keys[i], o, w, k, old_body, new_body);
  moved[i] = row_moved(o, w, k);
}

// The k = 1 diff of two Memento epochs of one n: each key's two lookups by
// memento_pair, one jump32 for both and both first reads in flight together.
template <class RO, class RN>
__global__ void memento_pair_diff_kernel(const uint32_t* __restrict__ keys,
                                         int32_t* __restrict__ old_out,
                                         int32_t* __restrict__ new_out,
                                         int32_t* __restrict__ moved, int64_t count,
                                         MementoT<RO> old_body, MementoT<RN> new_body) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= count) return;
  int32_t o = 0, w = 0;
  memento_pair(keys[i], old_body, new_body, true, true, o, w);
  old_out[i] = o;
  new_out[i] = w;
  moved[i] = o != w;
}

// Whether two AnchorHash epochs of one a nest: one epoch (the shallower,
// S) removed only buckets the other (D) also removed, with the same A and
// K, and D stamped every other bucket below S's working count N_S.  From
// the arrays alone, with N_S = min(a, the least positive A of S): for every
// bucket b, A_S[b] > 0 implies A_D[b] == A_S[b] and K_D[b] == K_S[b], and
// A_S[b] <= 0 implies A_D[b] < N_S.  Those are what anchor_nested needs to
// give both epochs' lookups, whatever the arrays' history; epochs whose
// removal stacks extend one another satisfy them, N_S then being S's
// working count.  kNestNone: they do not nest (diverging stacks); else the
// older or the newer epoch is S.  The two epochs may differ in width: every
// A and K word is widened to int32 as it is read.
constexpr int32_t kNestNone = 0, kNestOldShallow = 1, kNestNewShallow = 2;

// The check's per-call workspace, kNestWords words the caller passes (the
// tail of the diff's moved), so that no two calls share state.  The check
// writes the verdict and N_S, which the pair kernel reads.  The grid check
// (anchor_nest_kernel) zeroes the workspace's head first and keeps there,
// for each candidate S (old, new): the least positive A, as 0xFFFFFFFF -
// A; the largest A of the other epoch where S's is not positive, as A ^
// 0x80000000 (both unsigned maxima, so that 0 stands for none); whether any
// bucket S removed differs in the other; and blocks_done, the blocks that
// added theirs.  The parted check (anchor_nest_part_kernel) needs no
// zeroing: each of its blocks writes its own sums into `part` (least,
// most, differs of each candidate), which anchor_nest_verdict_kernel
// reduces.
constexpr int kNestParts = 32;  // blocks of the parted check at most
struct NestWork {
  int32_t verdict, n_shallow;
  uint32_t least[2], most[2], differs[2], blocks_done;
  int32_t part[6][kNestParts];
};
constexpr int kNestWords = 201;
static_assert(sizeof(NestWork) == 4 * kNestWords, "NestWork is kNestWords words");
constexpr int kNestItems = 16;  // buckets a thread of the grid check reads
// The parted check serves tables of at most kNestBlockMax buckets, every
// int8 and int16 table: one bucket a thread, kNestPartThreads a block.
constexpr int kNestPartThreads = 1024;
constexpr int32_t kNestBlockMax = 1 << 15;
static_assert(kNestBlockMax == kNestParts * kNestPartThreads, "a part a block");

// Programmatic dependent launch (sm_90).  A kernel that launch_dependent
// launches may begin before the kernel ahead of it on the stream ends; it
// waits in grid_dependency_wait, before it reads what that kernel writes,
// until that kernel has ended and its writes are visible.  A kernel lets
// the one after it begin with grid_launch_dependents.
__device__ __forceinline__ void grid_dependency_wait() {
#if defined(__CUDA_ARCH__)
  asm volatile("griddepcontrol.wait;" ::: "memory");
#endif
}
__device__ __forceinline__ void grid_launch_dependents() {
#if defined(__CUDA_ARCH__)
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
#endif
}

// Adds one bucket, whose As are ao and an (widened), to a thread's sums for
// both candidates S (index 0: the older epoch, 1: the newer); kdiff() says
// whether its Ks differ, asked only where an epoch removed it.
template <class KDiff>
__device__ __forceinline__ void nest_add(int32_t ao, int32_t an, KDiff kdiff,
                                         int32_t least[2], int32_t most[2],
                                         int32_t differs[2]) {
  if (ao > 0) {
    if (ao < least[0]) least[0] = ao;
  } else if (an > most[0]) {
    most[0] = an;
  }
  if (an > 0) {
    if (an < least[1]) least[1] = an;
  } else if (ao > most[1]) {
    most[1] = ao;
  }
  if ((ao > 0 || an > 0) && (ao != an || kdiff())) {
    differs[0] |= ao > 0;
    differs[1] |= an > 0;
  }
}

// The verdict and N_S from the whole table's sums (least: the least
// positive A of S, 0xFFFFFFFF for none; most: the largest A of the other
// epoch where S's is not positive, INT32_MIN for none), into `work`.
__device__ __forceinline__ void nest_verdict(const uint32_t least[2], const int32_t most[2],
                                             const uint32_t differs[2], int32_t a,
                                             NestWork* work) {
  int32_t verdict = kNestNone, n_shallow = 0;
  for (int e = 1; e >= 0; --e) {  // equal epochs: the older one as S
    const int32_t n = least[e] < static_cast<uint32_t>(a) ? static_cast<int32_t>(least[e]) : a;
    if (!differs[e] && most[e] < n) {
      verdict = e == 0 ? kNestOldShallow : kNestNewShallow;
      n_shallow = n;
    }
  }
  work->verdict = verdict;
  work->n_shallow = n_shallow;
}

// The check over a grid, in one pass over both epochs' A and, where either
// removed a bucket, both Ks: each block sums its buckets in shared memory,
// then into the workspace `work`, zeroed before the launch; the last block
// to finish writes the verdict.
template <class TO, class TN>
__global__ void anchor_nest_kernel(const TO* __restrict__ A_old, const TO* __restrict__ K_old,
                                   const TN* __restrict__ A_new, const TN* __restrict__ K_new,
                                   int32_t a, NestWork* work) {
  __shared__ int32_t s[6];
  if (threadIdx.x < 6)
    s[threadIdx.x] = threadIdx.x < 2 ? INT32_MAX : threadIdx.x < 4 ? INT32_MIN : 0;
  __syncthreads();
  int32_t least[2] = {INT32_MAX, INT32_MAX}, most[2] = {INT32_MIN, INT32_MIN};
  int32_t differs[2] = {0, 0};
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t b = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; b < a;
       b += stride) {
    nest_add(static_cast<int32_t>(A_old[b]), static_cast<int32_t>(A_new[b]),
             [&] { return static_cast<int32_t>(K_old[b]) != static_cast<int32_t>(K_new[b]); },
             least, most, differs);
  }
  for (int e = 0; e < 2; ++e) {
    atomicMin(&s[e], least[e]);
    atomicMax(&s[2 + e], most[e]);
    atomicOr(&s[4 + e], differs[e]);
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  for (int e = 0; e < 2; ++e) {
    atomicMax(&work->least[e], 0xFFFFFFFFu - static_cast<uint32_t>(s[e]));
    atomicMax(&work->most[e], static_cast<uint32_t>(s[2 + e]) ^ 0x80000000u);
    atomicOr(&work->differs[e], static_cast<uint32_t>(s[4 + e]));
  }
  __threadfence();
  if (atomicAdd(&work->blocks_done, 1u) != gridDim.x - 1) return;
  __threadfence();  // every other block's sums are in
  uint32_t all_least[2], all_differs[2];
  int32_t all_most[2];
  for (int e = 0; e < 2; ++e) {
    all_least[e] = 0xFFFFFFFFu - atomicAdd(&work->least[e], 0u);
    all_most[e] = static_cast<int32_t>(atomicAdd(&work->most[e], 0u) ^ 0x80000000u);
    all_differs[e] = atomicAdd(&work->differs[e], 0u);
  }
  nest_verdict(all_least, all_most, all_differs, a, work);
}

// The check for a <= kNestBlockMax, in ceil(a / kNestPartThreads) blocks
// of one bucket a thread, whose four words (both As and both Ks, whether
// needed or not) it loads at once.  Each warp reduces its sums in one
// instruction a sum, the block in shared memory.  A single block writes
// the verdict itself; more write their sums into the workspace's parts,
// which anchor_nest_verdict_kernel reduces.  No memset, no atomics across
// blocks; every block lets the kernel after it begin its launch.
template <class TO, class TN>
__global__ void __launch_bounds__(kNestPartThreads)
    anchor_nest_part_kernel(const TO* __restrict__ A_old, const TO* __restrict__ K_old,
                            const TN* __restrict__ A_new, const TN* __restrict__ K_new,
                            int32_t a, NestWork* work) {
  grid_launch_dependents();
  __shared__ int32_t s[6];
  if (threadIdx.x < 6)
    s[threadIdx.x] = threadIdx.x < 2 ? INT32_MAX : threadIdx.x < 4 ? INT32_MIN : 0;
  __syncthreads();
  int32_t least[2] = {INT32_MAX, INT32_MAX}, most[2] = {INT32_MIN, INT32_MIN};
  int32_t differs[2] = {0, 0};
  const int32_t b = static_cast<int32_t>(blockIdx.x) * kNestPartThreads +
                    static_cast<int32_t>(threadIdx.x);
  if (b < a) {
    const int32_t ao = A_old[b], an = A_new[b], ko = K_old[b], kn = K_new[b];
    nest_add(ao, an, [&] { return ko != kn; }, least, most, differs);
  }
  for (int e = 0; e < 2; ++e) {
    least[e] = __reduce_min_sync(0xFFFFFFFFu, least[e]);
    most[e] = __reduce_max_sync(0xFFFFFFFFu, most[e]);
    differs[e] = static_cast<int32_t>(
        __reduce_or_sync(0xFFFFFFFFu, static_cast<uint32_t>(differs[e])));
  }
  if ((threadIdx.x & 31u) == 0) {
    for (int e = 0; e < 2; ++e) {
      atomicMin(&s[e], least[e]);
      atomicMax(&s[2 + e], most[e]);
      atomicOr(&s[4 + e], differs[e]);
    }
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  if (gridDim.x == 1) {
    const uint32_t all_least[2] = {static_cast<uint32_t>(s[0]), static_cast<uint32_t>(s[1])};
    const int32_t all_most[2] = {s[2], s[3]};
    const uint32_t all_differs[2] = {static_cast<uint32_t>(s[4]), static_cast<uint32_t>(s[5])};
    nest_verdict(all_least, all_most, all_differs, a, work);
    return;
  }
  for (int j = 0; j < 6; ++j) work->part[j][blockIdx.x] = s[j];
}

// The verdict from the parted check's `parts` blocks' sums: one warp,
// launched by launch_dependent after anchor_nest_part_kernel.
__global__ void anchor_nest_verdict_kernel(NestWork* work, int32_t parts, int32_t a) {
  grid_launch_dependents();
  grid_dependency_wait();
  const uint32_t l = threadIdx.x;
  const bool in = l < static_cast<uint32_t>(parts);
  uint32_t least[2], differs[2];
  int32_t most[2];
  for (int e = 0; e < 2; ++e) {
    least[e] = static_cast<uint32_t>(
        __reduce_min_sync(0xFFFFFFFFu, in ? work->part[e][l] : INT32_MAX));
    most[e] = __reduce_max_sync(0xFFFFFFFFu, in ? work->part[2 + e][l] : INT32_MIN);
    differs[e] = __reduce_or_sync(0xFFFFFFFFu,
                                  in ? static_cast<uint32_t>(work->part[4 + e][l]) : 0u);
  }
  if (l == 0) nest_verdict(least, most, differs, a, work);
}

// Both AnchorHash epochs' rows of one key on one salt walk, the epochs
// nesting (anchor_nest_kernel): replica_pair_row's walk, each salt's
// candidate key looked up in both epochs by one anchor_nested walk through
// the deeper epoch's tables `deep`; a salt only the shallower row still
// needs stops at the shallower answer.  s and d are the shallower and the
// deeper epoch's rows.
template <class T>
__device__ void anchor_pair_row(uint32_t key, int32_t* s, int32_t* d, int32_t k,
                                const AnchorT<T>& deep, int32_t n_shallow) {
  int32_t js = 0, jd = 0;
  for (int32_t salt = 0; salt <= kReplicaSaltCap && (js < k || jd < k); ++salt) {
    const bool gs = js < k, gd = jd < k;
    int32_t cs = 0, cd = 0;
    anchor_nested(salt == 0 ? key : hash2(key, static_cast<uint32_t>(salt)), deep.A, deep.K,
                  deep.a, n_shallow, gd, cs, cd);
    if (gs && row_takes(s, js, cs, nullptr, 0)) s[js++] = cs;
    if (gd && row_takes(d, jd, cd, nullptr, 0)) d[jd++] = cd;
  }
  row_keep_first(s, js, k, s[0]);
  row_keep_first(d, jd, k, d[0]);
}

// anchor_replica_diff and anchor_packed_replica_diff after their check: the
// verdict in `work`, one for the launch, picks the pair walk through the
// deeper epoch's tables (of its own width), or, for epochs that do not
// nest, each epoch's replica_row (replica_diff_kernel's rows).
template <class TO, class TN>
__global__ void anchor_pair_replica_diff_kernel(const uint32_t* __restrict__ keys,
                                                int32_t* old_out, int32_t* new_out,
                                                int32_t* __restrict__ moved, int64_t count,
                                                int32_t k, AnchorT<TO> old_body,
                                                AnchorT<TN> new_body,
                                                const NestWork* __restrict__ work) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= count) return;
  const uint32_t key = keys[i];
  grid_dependency_wait();  // the check's verdict
  const NestWork& nest = *work;
  int32_t* o = old_out + i * k;
  int32_t* w = new_out + i * k;
  if (nest.verdict == kNestOldShallow) {
    anchor_pair_row(key, o, w, k, new_body, nest.n_shallow);
  } else if (nest.verdict == kNestNewShallow) {
    anchor_pair_row(key, w, o, k, old_body, nest.n_shallow);
  } else {
    replica_row<false>(key, o, k, old_body, nullptr, 0);
    replica_row<false>(key, w, k, new_body, nullptr, 0);
  }
  moved[i] = row_moved(o, w, k);
}

// anchor_packed_diff after its check: for nesting epochs both lookups of a
// key on one anchor_nested walk through the deeper epoch's tables; else
// each epoch's anchor_one, as diff_kernel runs them.
template <class TO, class TN>
__global__ void anchor_pair_diff_kernel(const uint32_t* __restrict__ keys,
                                        int32_t* __restrict__ old_out,
                                        int32_t* __restrict__ new_out,
                                        int32_t* __restrict__ moved, int64_t count,
                                        AnchorT<TO> old_body, AnchorT<TN> new_body,
                                        const NestWork* __restrict__ work) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= count) return;
  const uint32_t key = keys[i];
  grid_dependency_wait();  // the check's verdict
  const NestWork& nest = *work;
  int32_t o, w;
  if (nest.verdict == kNestOldShallow) {
    anchor_nested(key, new_body.A, new_body.K, new_body.a, nest.n_shallow, true, o, w);
  } else if (nest.verdict == kNestNewShallow) {
    anchor_nested(key, old_body.A, old_body.K, old_body.a, nest.n_shallow, true, w, o);
  } else {
    o = old_body(key);
    w = new_body(key);
  }
  old_out[i] = o;
  new_out[i] = w;
  moved[i] = o != w;
}

// chain_walk_body: b = lookup(chain) for every lane; a pending lane steps
// probe += 1, chain = hash2(chain, probe), b = lookup(chain) while
// load[b] >= cap and probe < max_probe (64 * len(load) + 64, below 2^31).
template <class Body>
__global__ void walk_kernel(const uint32_t* __restrict__ chain_in,
                            const int32_t* __restrict__ probe_in,
                            const uint8_t* __restrict__ pending,
                            int32_t* __restrict__ b_out, uint32_t* __restrict__ chain_out,
                            int32_t* __restrict__ probe_out, int64_t count,
                            const int32_t* __restrict__ load, int32_t cap,
                            int32_t max_probe, Body body) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= count) return;
  uint32_t chain = chain_in[i];
  int32_t probe = probe_in[i];
  int32_t b = body(chain);
  if (pending[i]) {
    while (load[b] >= cap && probe < max_probe) {
      ++probe;
      chain = hash2(chain, static_cast<uint32_t>(probe));
      b = body(chain);
    }
  }
  b_out[i] = b;
  chain_out[i] = chain;
  probe_out[i] = probe;
}

// dx_walk at G lanes a walk lane: walk_kernel's step with every lookup the
// group's dx_group_bucket, so every lane of the group holds the same b,
// chain and probe.  The group steps while `open`: pending, probe below
// max_probe and load[b] >= cap, read by every lane at one address, so
// `open` agrees over the group.  The warp loops while any of its groups is
// open; a lane past `count`, not pending or of a finished group joins every
// collective with `open` false.  The group's first lane stores.
template <int G>
__global__ void dx_group_walk_kernel(const uint32_t* __restrict__ chain_in,
                                     const int32_t* __restrict__ probe_in,
                                     const uint8_t* __restrict__ pending,
                                     int32_t* __restrict__ b_out,
                                     uint32_t* __restrict__ chain_out,
                                     int32_t* __restrict__ probe_out, int64_t count,
                                     const int32_t* __restrict__ load, int32_t cap,
                                     int32_t max_probe, Dx dx) {
  const int64_t q = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) / G;
  const bool live = q < count;
  uint32_t chain = live ? chain_in[q] : 0u;
  int32_t probe = live ? probe_in[q] : 0;
  int32_t b = dx_group_bucket<G>(dx, chain, live);
  bool open = live && pending[q] && probe < max_probe && load[b] >= cap;
  while (__any_sync(0xFFFFFFFFu, open)) {
    if (open) chain = hash2(chain, static_cast<uint32_t>(++probe));
    const int32_t next = dx_group_bucket<G>(dx, chain, open);
    if (open) {
      b = next;
      open = probe < max_probe && load[b] >= cap;
    }
  }
  if (live && (threadIdx.x & (G - 1u)) == 0) {
    b_out[q] = b;
    chain_out[q] = chain;
    probe_out[q] = probe;
  }
}

unsigned int blocks_for(long long count) {
  return static_cast<unsigned int>((count + kThreads - 1) / kThreads);
}

template <class Body>
int launch_lookup(const void* keys, void* out, long long count, Body body,
                  void* stream) {
  lookup_kernel<Body><<<blocks_for(count), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(keys), static_cast<int32_t*>(out), count, body);
  return static_cast<int>(cudaGetLastError());
}

// The lanes a dx_lookup key takes: the largest power of two <= ceil(a/w) /
// 4, within [1, 32], from the host's probe bound max_probes = 64 *
// ceil(a/w); so a key's expected ceil(a/w) probes take about four rounds
// of its group.  G = 1 is one thread a key (lookup_kernel).
int dx_group(int max_probes) {
  int g = 1;
  while (2 * g <= max_probes / 256 && g < 32) g <<= 1;
  return g;
}

// The lanes a dx_diff key takes: half dx_lookup's G for the epoch with
// more probes, at most 16 (one thread a key below 2).  A diff's group
// probes both epochs, and the stable epoch of a stable -> one-shot diff (~4
// probes a key) loses to large groups: on an NVIDIA H100 80GB HBM3 at
// 700.00 W half dx_group's G ran 3.5 % faster there (G = 4 against 8),
// 8.7 % between epochs at ceil(a/w) = 8 (one thread against G = 2) and
// 1.2 % between two one-shot epochs (PERF.md).
int dx_diff_group(int max_probes_old, int max_probes_new) {
  const int g = dx_group(max_probes_old > max_probes_new ? max_probes_old : max_probes_new);
  return g > 1 ? g / 2 : 1;
}

// The lanes a dx_replica key takes: dx_lookup's G (one thread a key below
// 2), since each lookup of a replica set probes as a lookup does; on an
// NVIDIA H100 80GB HBM3 at 700.00 W it ran faster than G/2 and 2G at
// ceil(a/w) = 40, k = 3 and bounded k = 2 (PERF.md).
int dx_replica_group(int max_probes) { return dx_group(max_probes); }

// The lanes a dx_walk lane takes: dx_lookup's G (one thread a lane below
// 2), since each lookup of a walk step probes as a lookup does; on an
// NVIDIA H100 80GB HBM3 at 700.00 W it ran faster than G/2 at ceil(a/w) =
// 40, one step of half the lanes at bounded_assign's cap (PERF.md).
int dx_walk_group(int max_probes) { return dx_group(max_probes); }

// The lanes a dx_replica_diff key takes in the epoch with more probes:
// dx_replica's G there when it is at least 8, and then each epoch's rows
// are dx_replica's (its own G, one thread a key below 2) and a pass
// compares them; else one thread a key for both epochs
// (replica_diff_kernel).  On an NVIDIA H100 80GB HBM3 at 700.00 W, against
// one thread a key, the split ran stable -> one-shot (G = 1 and 8) -3.7 %
// and between two one-shot epochs (G = 8) -8.3 %, but at G = 2 in both
// epochs (w = 5*10^5) +24.4 % (PERF.md).  G = 4 (ceil(a/w) 16 to 31) was
// not timed: it keeps one thread a key, the kernel it had before the split.
int dx_replica_diff_group(int max_probes_old, int max_probes_new) {
  const int g =
      dx_replica_group(max_probes_old > max_probes_new ? max_probes_old : max_probes_new);
  return g >= 8 ? g : 1;
}

template <int G>
int launch_dx_group(const void* keys, void* out, long long count, Dx dx, void* stream) {
  dx_group_kernel<G><<<blocks_for(count * G), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(keys), static_cast<int32_t*>(out), count, dx);
  return static_cast<int>(cudaGetLastError());
}

template <int G>
int launch_dx_group_diff(const void* keys, void* old_out, void* new_out, void* moved,
                         long long count, Dx old_dx, Dx new_dx, void* stream) {
  dx_group_diff_kernel<G><<<blocks_for(count * G), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(keys), static_cast<int32_t*>(old_out),
      static_cast<int32_t*>(new_out), static_cast<int32_t*>(moved), count, old_dx, new_dx);
  return static_cast<int>(cudaGetLastError());
}

template <int G>
int launch_dx_group_walk(const void* chain, const void* probe, const void* pending, void* b,
                         void* chain_out, void* probe_out, long long count, const void* load,
                         int cap, int max_probe, Dx dx, void* stream) {
  dx_group_walk_kernel<G><<<blocks_for(count * G), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(chain), static_cast<const int32_t*>(probe),
      static_cast<const uint8_t*>(pending), static_cast<int32_t*>(b),
      static_cast<uint32_t*>(chain_out), static_cast<int32_t*>(probe_out), count,
      static_cast<const int32_t*>(load), cap, max_probe, dx);
  return static_cast<int>(cudaGetLastError());
}

template <int G>
int launch_dx_group_replica(const void* keys, void* out, long long count, int k,
                            const void* load, int cap, Dx dx, void* stream) {
  dx_group_replica_kernel<G><<<blocks_for(count * G), kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(keys), static_cast<int32_t*>(out), count, k,
      static_cast<const int32_t*>(load), cap, dx);
  return static_cast<int>(cudaGetLastError());
}

template <class Old, class New>
int launch_diff(const void* keys, void* old_out, void* new_out, void* moved,
                long long count, Old old_body, New new_body, void* stream) {
  diff_kernel<Old, New><<<blocks_for(count), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(keys), static_cast<int32_t*>(old_out),
      static_cast<int32_t*>(new_out), static_cast<int32_t*>(moved), count,
      old_body, new_body);
  return static_cast<int>(cudaGetLastError());
}

// Two PowerHash epochs of one top level share each key's draws
// (power_pair_diff_kernel); of two levels they share nothing, and
// diff_kernel runs them one after the other.
int launch_power_diff(const void* keys, void* old_out, void* new_out, void* moved,
                      long long count, Power po, Power pn, void* stream) {
  if (po.L != pn.L)
    return launch_diff(keys, old_out, new_out, moved, count, po, pn, stream);
  power_pair_diff_kernel<<<blocks_for(count), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(keys), static_cast<int32_t*>(old_out),
      static_cast<int32_t*>(new_out), static_cast<int32_t*>(moved), count, po, pn);
  return static_cast<int>(cudaGetLastError());
}

template <class Body>
int launch_replica(const void* keys, void* out, long long count, int k, const void* load,
                   int cap, Body body, void* stream) {
  if (load != nullptr)
    replica_kernel<true, Body><<<blocks_for(count), kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(keys), static_cast<int32_t*>(out), count, k,
        static_cast<const int32_t*>(load), cap, body);
  else
    replica_kernel<false, Body><<<blocks_for(count), kThreads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(keys), static_cast<int32_t*>(out), count, k,
        nullptr, cap, body);
  return static_cast<int>(cudaGetLastError());
}

template <class Old, class New>
int launch_replica_diff(const void* keys, void* old_out, void* new_out, void* moved,
                        long long count, int k, Old old_body, New new_body,
                        void* stream) {
  replica_diff_kernel<Old, New><<<blocks_for(count), kThreads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(keys), static_cast<int32_t*>(old_out),
      static_cast<int32_t*>(new_out), static_cast<int32_t*>(moved), count, k,
      old_body, new_body);
  return static_cast<int>(cudaGetLastError());
}

// Two Memento epochs of one n share each key's jump32 (memento_pair); of
// different n (the last bucket removed, a bucket added) they share
// nothing, and diff_kernel runs them one after the other.  Against
// diff_kernel at every n the pair ran int16 n = 10^4 -40.9 %, int8 n = 100
// -16.9 %, dense stable -> one-shot -5.2 % and packed int32 -1.9 %
// (NVIDIA H100 80GB HBM3, 700.00 W).
template <class RO, class RN>
int launch_memento_diff(const void* keys, void* old_out, void* new_out, void* moved,
                        long long count, MementoT<RO> old_body, MementoT<RN> new_body,
                        void* stream) {
  if (old_body.n != new_body.n)
    return launch_diff(keys, old_out, new_out, moved, count, old_body, new_body, stream);
  memento_pair_diff_kernel<RO, RN><<<blocks_for(count), kThreads, 0,
                                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(keys), static_cast<int32_t*>(old_out),
      static_cast<int32_t*>(new_out), static_cast<int32_t*>(moved), count, old_body,
      new_body);
  return static_cast<int>(cudaGetLastError());
}

// Two Memento epochs of one n share each salt's jump32: the pair walk.
// Of different n they share nothing, and two replica_rows ran faster
// (PERF.md).  Against the single read alone (two replica_rows at every n)
// the pair ran int16 n = 10^4 -36.5 %, int8 n = 100 -16.6 %, dense
// stable -> one-shot -9.6 % and packed int32 stable -> one-shot -1.1 %
// (NVIDIA H100 80GB HBM3, 700.00 W): it is kept for the states where
// jump32 is most of the time or both epochs are churned.
template <class RO, class RN>
int launch_memento_replica_diff(const void* keys, void* old_out, void* new_out, void* moved,
                                long long count, int k, MementoT<RO> old_body,
                                MementoT<RN> new_body, void* stream) {
  if (old_body.n != new_body.n)
    return launch_replica_diff(keys, old_out, new_out, moved, count, k, old_body, new_body,
                               stream);
  replica_pair_kernel<RO, RN><<<blocks_for(count), kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(keys), static_cast<int32_t*>(old_out),
      static_cast<int32_t*>(new_out), static_cast<int32_t*>(moved), count, k, old_body,
      new_body);
  return static_cast<int>(cudaGetLastError());
}

template <class Body>
int launch_walk(const void* chain, const void* probe, const void* pending, void* b,
                void* chain_out, void* probe_out, long long count, const void* load,
                int cap, int max_probe, Body body, void* stream) {
  walk_kernel<Body><<<blocks_for(count), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(chain), static_cast<const int32_t*>(probe),
      static_cast<const uint8_t*>(pending), static_cast<int32_t*>(b),
      static_cast<uint32_t*>(chain_out), static_cast<int32_t*>(probe_out), count,
      static_cast<const int32_t*>(load), cap, max_probe, body);
  return static_cast<int>(cudaGetLastError());
}

// Launches kernel k as a dependent of the kernel ahead of it on the stream
// (programmatic dependent launch): its launch may overlap that kernel,
// and k waits for it in grid_dependency_wait.
template <class... Params, class... Args>
int launch_dependent(void (*k)(Params...), unsigned int blocks, unsigned int threads,
                     void* stream, Args... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(blocks);
  config.blockDim = dim3(threads);
  config.dynamicSmemBytes = 0;
  config.stream = static_cast<cudaStream_t>(stream);
  config.attrs = attr;
  config.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&config, k, static_cast<Params>(args)...));
}

// The check over two AnchorHash epochs of one a (of any widths) into the
// call's workspace `work`: for a <= kNestBlockMax the parted check (one
// block, or more and the verdict kernel after them), else the grid
// (anchor_nest_kernel, the workspace zeroed first).
template <class TO, class TN>
int launch_anchor_nest(AnchorT<TO> old_body, AnchorT<TN> new_body, NestWork* work,
                       void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t a = old_body.a;
  if (a <= kNestBlockMax) {
    const int32_t parts = (a + kNestPartThreads - 1) / kNestPartThreads;
    anchor_nest_part_kernel<TO, TN><<<parts, kNestPartThreads, 0, s>>>(
        old_body.A, old_body.K, new_body.A, new_body.K, a, work);
    const int rc = static_cast<int>(cudaGetLastError());
    if (rc != 0 || parts == 1) return rc;
    return launch_dependent(anchor_nest_verdict_kernel, 1, 32, stream, work, parts, a);
  }
  const long long per_block = static_cast<long long>(kThreads) * kNestItems;
  cudaMemsetAsync(work, 0, sizeof(NestWork), s);
  anchor_nest_kernel<TO, TN><<<static_cast<unsigned int>((a + per_block - 1) / per_block),
                               kThreads, 0, s>>>(old_body.A, old_body.K, new_body.A,
                                                 new_body.K, a, work);
  return static_cast<int>(cudaGetLastError());
}

// The check's workspace of an AnchorHash diff: the tail of `moved`, which
// holds count + kNestWords words, so that the entry's arguments stay every
// diff entry's.  Of two a the epochs share no walk, and the verdict is
// zeroed (kNestNone).
NestWork* nest_work(void* moved, long long count) {
  return reinterpret_cast<NestWork*>(static_cast<int32_t*>(moved) + count);
}

// Two AnchorHash epochs of one a: the check, then the pair kernel, which
// takes the nested walk or each epoch's replica_row as the check found.  Of
// two a: replica_diff_kernel.
template <class TO, class TN>
int launch_anchor_replica_diff(const void* keys, void* old_out, void* new_out, void* moved,
                               long long count, int k, AnchorT<TO> old_body,
                               AnchorT<TN> new_body, void* stream) {
  NestWork* work = nest_work(moved, count);
  if (old_body.a != new_body.a) {
    cudaMemsetAsync(work, 0, sizeof(NestWork), static_cast<cudaStream_t>(stream));
    return launch_replica_diff(keys, old_out, new_out, moved, count, k, old_body, new_body,
                               stream);
  }
  const int rc = launch_anchor_nest(old_body, new_body, work, stream);
  if (rc != 0) return rc;
  return launch_dependent(anchor_pair_replica_diff_kernel<TO, TN>, blocks_for(count), kThreads,
                          stream, keys, old_out, new_out, moved, count, k, old_body, new_body,
                          work);
}

// The k = 1 diff of two packed AnchorHash epochs of one a: the check, then
// anchor_pair_diff_kernel.  Of two a: diff_kernel.
template <class TO, class TN>
int launch_anchor_diff(const void* keys, void* old_out, void* new_out, void* moved,
                       long long count, AnchorT<TO> old_body, AnchorT<TN> new_body,
                       void* stream) {
  NestWork* work = nest_work(moved, count);
  if (old_body.a != new_body.a) {
    cudaMemsetAsync(work, 0, sizeof(NestWork), static_cast<cudaStream_t>(stream));
    return launch_diff(keys, old_out, new_out, moved, count, old_body, new_body, stream);
  }
  const int rc = launch_anchor_nest(old_body, new_body, work, stream);
  if (rc != 0) return rc;
  return launch_dependent(anchor_pair_diff_kernel<TO, TN>, blocks_for(count), kThreads, stream,
                          keys, old_out, new_out, moved, count, old_body, new_body, work);
}

MementoT<DenseRepl> memento(const void* repl, int n) {
  return {{static_cast<const int32_t*>(repl)}, n};
}
template <class T>
MementoT<PackedRepl<T>> memento_packed(const void* state, const void* slot_b,
                                       const void* slot_c, int nslots, int n) {
  return {{static_cast<const uint32_t*>(state), static_cast<const T*>(slot_b),
           static_cast<const T*>(slot_c), static_cast<uint32_t>(nslots) - 1u},
          n};
}
MementoT<CompactRepl> memento_compact(const void* slot_b, const void* slot_c, int nslots,
                                      int n) {
  return {{static_cast<const int32_t*>(slot_b), static_cast<const int32_t*>(slot_c),
           static_cast<uint32_t>(nslots) - 1u},
          n};
}
Power power(int n) {
  int32_t L = 0;
  while (((n - 1) >> (L + 1)) > 0) ++L;
  return {n, L, (2u << L) - 1u};
}
template <class T = int32_t>
AnchorT<T> anchor(const void* A, const void* K, int a) {
  return {static_cast<const T*>(A), static_cast<const T*>(K), a};
}
Dx dx(const void* words, int a, int max_probes, int fallback) {
  return {static_cast<const uint32_t*>(words), UINT64_MAX / static_cast<uint32_t>(a) + 1u, a,
          max_probes, fallback};
}

// Calls f with a value of the signed integer type `width` bytes wide: the
// element type of a packed table.
template <class F>
int with_width(int width, F&& f) {
  switch (width) {
    case 1: return f(int8_t{0});
    case 2: return f(int16_t{0});
    case 4: return f(int32_t{0});
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// The plain C interface (ctypes): the input and output pointers, the count,
// the mode's own arguments, then each epoch's tables (int32, or uint32 words
// for dx) and int scalars in the registry's order, then the stream.  Each
// returns cudaGetLastError() after its launch.
//   lookup        keys uint32 [count] -> out int32 [count]
//   diff          keys -> old, new, moved 0/1, int32 [count] each
//   replica       keys -> out int32 [count, k]; k, load (int32 words, or
//                 null for unbounded), cap
//   replica_diff  keys -> old, new int32 [count, k], moved [count]; k
//   walk          chain uint32, probe int32, pending uint8 [count] -> b,
//                 chain, probe [count]; load, cap, max_probe
// A packed Memento epoch is state (uint32 words), slot_b, slot_c, the
// slots' width in bytes, the slot count (a power of two) and n; a packed
// AnchorHash epoch A, K, their width and a; a compact epoch slot_b, slot_c
// (int32), the slot count and n.
extern "C" {

int memento_lookup(const void* keys, void* out, long long count,
                   const void* repl, int n, void* stream) {
  return launch_lookup(keys, out, count, memento(repl, n), stream);
}

int memento_diff(const void* keys, void* old_out, void* new_out, void* moved,
                 long long count, const void* repl_old, int n_old,
                 const void* repl_new, int n_new, void* stream) {
  return launch_memento_diff(keys, old_out, new_out, moved, count, memento(repl_old, n_old),
                             memento(repl_new, n_new), stream);
}

int anchor_lookup(const void* keys, void* out, long long count, const void* A,
                  const void* K, int a, void* stream) {
  return launch_lookup(keys, out, count, anchor(A, K, a), stream);
}

int anchor_diff(const void* keys, void* old_out, void* new_out, void* moved,
                long long count, const void* A_old, const void* K_old, int a_old,
                const void* A_new, const void* K_new, int a_new, void* stream) {
  return launch_diff(keys, old_out, new_out, moved, count, anchor(A_old, K_old, a_old),
                     anchor(A_new, K_new, a_new), stream);
}

int dx_lookup(const void* keys, void* out, long long count, const void* words,
              int a, int max_probes, int fallback, void* stream) {
  const Dx body = dx(words, a, max_probes, fallback);
  switch (dx_group(max_probes)) {
    case 1: return launch_lookup(keys, out, count, body, stream);
    case 2: return launch_dx_group<2>(keys, out, count, body, stream);
    case 4: return launch_dx_group<4>(keys, out, count, body, stream);
    case 8: return launch_dx_group<8>(keys, out, count, body, stream);
    case 16: return launch_dx_group<16>(keys, out, count, body, stream);
    default: return launch_dx_group<32>(keys, out, count, body, stream);
  }
}

int dx_diff(const void* keys, void* old_out, void* new_out, void* moved,
            long long count, const void* words_old, int a_old, int max_probes_old,
            int fallback_old, const void* words_new, int a_new, int max_probes_new,
            int fallback_new, void* stream) {
  const Dx o = dx(words_old, a_old, max_probes_old, fallback_old);
  const Dx w = dx(words_new, a_new, max_probes_new, fallback_new);
  switch (dx_diff_group(max_probes_old, max_probes_new)) {
    case 1: return launch_diff(keys, old_out, new_out, moved, count, o, w, stream);
    case 2: return launch_dx_group_diff<2>(keys, old_out, new_out, moved, count, o, w, stream);
    case 4: return launch_dx_group_diff<4>(keys, old_out, new_out, moved, count, o, w, stream);
    case 8: return launch_dx_group_diff<8>(keys, old_out, new_out, moved, count, o, w, stream);
    default: return launch_dx_group_diff<16>(keys, old_out, new_out, moved, count, o, w, stream);
  }
}

int jump_lookup(const void* keys, void* out, long long count, int n, void* stream) {
  return launch_lookup(keys, out, count, Jump{n}, stream);
}

int jump_diff(const void* keys, void* old_out, void* new_out, void* moved,
              long long count, int n_old, int n_new, void* stream) {
  return launch_diff(keys, old_out, new_out, moved, count, Jump{n_old}, Jump{n_new},
                     stream);
}

int power_lookup(const void* keys, void* out, long long count, int n, void* stream) {
  return launch_lookup(keys, out, count, power(n), stream);
}

int power_diff(const void* keys, void* old_out, void* new_out, void* moved,
               long long count, int n_old, int n_new, void* stream) {
  return launch_power_diff(keys, old_out, new_out, moved, count, power(n_old), power(n_new),
                           stream);
}

int memento_replica(const void* keys, void* out, long long count, int k,
                    const void* load, int cap, const void* repl, int n, void* stream) {
  return launch_replica(keys, out, count, k, load, cap, memento(repl, n), stream);
}

int memento_replica_diff(const void* keys, void* old_out, void* new_out, void* moved,
                         long long count, int k, const void* repl_old, int n_old,
                         const void* repl_new, int n_new, void* stream) {
  return launch_memento_replica_diff(keys, old_out, new_out, moved, count, k,
                                     memento(repl_old, n_old), memento(repl_new, n_new),
                                     stream);
}

int memento_walk(const void* chain, const void* probe, const void* pending, void* b,
                 void* chain_out, void* probe_out, long long count, const void* load,
                 int cap, int max_probe, const void* repl, int n, void* stream) {
  return launch_walk(chain, probe, pending, b, chain_out, probe_out, count, load, cap,
                     max_probe, memento(repl, n), stream);
}

int anchor_replica(const void* keys, void* out, long long count, int k, const void* load,
                   int cap, const void* A, const void* K, int a, void* stream) {
  return launch_replica(keys, out, count, k, load, cap, anchor(A, K, a), stream);
}

int anchor_replica_diff(const void* keys, void* old_out, void* new_out, void* moved,
                        long long count, int k, const void* A_old, const void* K_old,
                        int a_old, const void* A_new, const void* K_new, int a_new,
                        void* stream) {
  return launch_anchor_replica_diff(keys, old_out, new_out, moved, count, k,
                                    anchor(A_old, K_old, a_old), anchor(A_new, K_new, a_new),
                                    stream);
}

int anchor_walk(const void* chain, const void* probe, const void* pending, void* b,
                void* chain_out, void* probe_out, long long count, const void* load,
                int cap, int max_probe, const void* A, const void* K, int a,
                void* stream) {
  return launch_walk(chain, probe, pending, b, chain_out, probe_out, count, load, cap,
                     max_probe, anchor(A, K, a), stream);
}

int dx_replica(const void* keys, void* out, long long count, int k, const void* load,
               int cap, const void* words, int a, int max_probes, int fallback,
               void* stream) {
  const Dx body = dx(words, a, max_probes, fallback);
  switch (dx_replica_group(max_probes)) {
    case 1: return launch_replica(keys, out, count, k, load, cap, body, stream);
    case 2: return launch_dx_group_replica<2>(keys, out, count, k, load, cap, body, stream);
    case 4: return launch_dx_group_replica<4>(keys, out, count, k, load, cap, body, stream);
    case 8: return launch_dx_group_replica<8>(keys, out, count, k, load, cap, body, stream);
    case 16: return launch_dx_group_replica<16>(keys, out, count, k, load, cap, body, stream);
    default: return launch_dx_group_replica<32>(keys, out, count, k, load, cap, body, stream);
  }
}

int dx_replica_diff(const void* keys, void* old_out, void* new_out, void* moved,
                    long long count, int k, const void* words_old, int a_old,
                    int max_probes_old, int fallback_old, const void* words_new,
                    int a_new, int max_probes_new, int fallback_new, void* stream) {
  if (dx_replica_diff_group(max_probes_old, max_probes_new) == 1)
    return launch_replica_diff(keys, old_out, new_out, moved, count, k,
                               dx(words_old, a_old, max_probes_old, fallback_old),
                               dx(words_new, a_new, max_probes_new, fallback_new), stream);
  // each epoch's rows by dx_replica, at its own G, then the moved pass
  int rc = dx_replica(keys, old_out, count, k, nullptr, 0, words_old, a_old, max_probes_old,
                      fallback_old, stream);
  if (rc == 0)
    rc = dx_replica(keys, new_out, count, k, nullptr, 0, words_new, a_new, max_probes_new,
                    fallback_new, stream);
  if (rc != 0) return rc;
  rows_moved_kernel<<<blocks_for(count), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(old_out), static_cast<const int32_t*>(new_out),
      static_cast<int32_t*>(moved), count, k);
  return static_cast<int>(cudaGetLastError());
}

int dx_walk(const void* chain, const void* probe, const void* pending, void* b,
            void* chain_out, void* probe_out, long long count, const void* load, int cap,
            int max_probe, const void* words, int a, int max_probes, int fallback,
            void* stream) {
  const Dx body = dx(words, a, max_probes, fallback);
  switch (dx_walk_group(max_probes)) {
    case 1:
      return launch_walk(chain, probe, pending, b, chain_out, probe_out, count, load, cap,
                         max_probe, body, stream);
    case 2:
      return launch_dx_group_walk<2>(chain, probe, pending, b, chain_out, probe_out, count,
                                     load, cap, max_probe, body, stream);
    case 4:
      return launch_dx_group_walk<4>(chain, probe, pending, b, chain_out, probe_out, count,
                                     load, cap, max_probe, body, stream);
    case 8:
      return launch_dx_group_walk<8>(chain, probe, pending, b, chain_out, probe_out, count,
                                     load, cap, max_probe, body, stream);
    case 16:
      return launch_dx_group_walk<16>(chain, probe, pending, b, chain_out, probe_out, count,
                                      load, cap, max_probe, body, stream);
    default:
      return launch_dx_group_walk<32>(chain, probe, pending, b, chain_out, probe_out, count,
                                      load, cap, max_probe, body, stream);
  }
}

int jump_replica(const void* keys, void* out, long long count, int k, const void* load,
                 int cap, int n, void* stream) {
  return launch_replica(keys, out, count, k, load, cap, Jump{n}, stream);
}

int jump_replica_diff(const void* keys, void* old_out, void* new_out, void* moved,
                      long long count, int k, int n_old, int n_new, void* stream) {
  return launch_replica_diff(keys, old_out, new_out, moved, count, k, Jump{n_old},
                             Jump{n_new}, stream);
}

int jump_walk(const void* chain, const void* probe, const void* pending, void* b,
              void* chain_out, void* probe_out, long long count, const void* load,
              int cap, int max_probe, int n, void* stream) {
  return launch_walk(chain, probe, pending, b, chain_out, probe_out, count, load, cap,
                     max_probe, Jump{n}, stream);
}

int power_replica(const void* keys, void* out, long long count, int k, const void* load,
                  int cap, int n, void* stream) {
  return launch_replica(keys, out, count, k, load, cap, power(n), stream);
}

int power_replica_diff(const void* keys, void* old_out, void* new_out, void* moved,
                       long long count, int k, int n_old, int n_new, void* stream) {
  return launch_replica_diff(keys, old_out, new_out, moved, count, k, power(n_old),
                             power(n_new), stream);
}

int power_walk(const void* chain, const void* probe, const void* pending, void* b,
               void* chain_out, void* probe_out, long long count, const void* load,
               int cap, int max_probe, int n, void* stream) {
  return launch_walk(chain, probe, pending, b, chain_out, probe_out, count, load, cap,
                     max_probe, power(n), stream);
}

int memento_packed_lookup(const void* keys, void* out, long long count, const void* state,
                          const void* slot_b, const void* slot_c, int width, int nslots,
                          int n, void* stream) {
  return with_width(width, [&](auto t) {
    return launch_lookup(keys, out, count,
                         memento_packed<decltype(t)>(state, slot_b, slot_c, nslots, n),
                         stream);
  });
}

int memento_packed_diff(const void* keys, void* old_out, void* new_out, void* moved,
                        long long count, const void* state_old, const void* slot_b_old,
                        const void* slot_c_old, int width_old, int nslots_old, int n_old,
                        const void* state_new, const void* slot_b_new,
                        const void* slot_c_new, int width_new, int nslots_new, int n_new,
                        void* stream) {
  return with_width(width_old, [&](auto to) {
    return with_width(width_new, [&](auto tn) {
      return launch_memento_diff(
          keys, old_out, new_out, moved, count,
          memento_packed<decltype(to)>(state_old, slot_b_old, slot_c_old, nslots_old, n_old),
          memento_packed<decltype(tn)>(state_new, slot_b_new, slot_c_new, nslots_new, n_new),
          stream);
    });
  });
}

int memento_packed_replica(const void* keys, void* out, long long count, int k,
                           const void* load, int cap, const void* state, const void* slot_b,
                           const void* slot_c, int width, int nslots, int n, void* stream) {
  return with_width(width, [&](auto t) {
    return launch_replica(keys, out, count, k, load, cap,
                          memento_packed<decltype(t)>(state, slot_b, slot_c, nslots, n),
                          stream);
  });
}

int memento_packed_replica_diff(const void* keys, void* old_out, void* new_out, void* moved,
                                long long count, int k, const void* state_old,
                                const void* slot_b_old, const void* slot_c_old,
                                int width_old, int nslots_old, int n_old,
                                const void* state_new, const void* slot_b_new,
                                const void* slot_c_new, int width_new, int nslots_new,
                                int n_new, void* stream) {
  return with_width(width_old, [&](auto to) {
    return with_width(width_new, [&](auto tn) {
      return launch_memento_replica_diff(
          keys, old_out, new_out, moved, count, k,
          memento_packed<decltype(to)>(state_old, slot_b_old, slot_c_old, nslots_old, n_old),
          memento_packed<decltype(tn)>(state_new, slot_b_new, slot_c_new, nslots_new, n_new),
          stream);
    });
  });
}

int memento_packed_walk(const void* chain, const void* probe, const void* pending, void* b,
                        void* chain_out, void* probe_out, long long count, const void* load,
                        int cap, int max_probe, const void* state, const void* slot_b,
                        const void* slot_c, int width, int nslots, int n, void* stream) {
  return with_width(width, [&](auto t) {
    return launch_walk(chain, probe, pending, b, chain_out, probe_out, count, load, cap,
                       max_probe,
                       memento_packed<decltype(t)>(state, slot_b, slot_c, nslots, n),
                       stream);
  });
}

int anchor_packed_lookup(const void* keys, void* out, long long count, const void* A,
                         const void* K, int width, int a, void* stream) {
  return with_width(width, [&](auto t) {
    return launch_lookup(keys, out, count, anchor<decltype(t)>(A, K, a), stream);
  });
}

int anchor_packed_diff(const void* keys, void* old_out, void* new_out, void* moved,
                       long long count, const void* A_old, const void* K_old, int width_old,
                       int a_old, const void* A_new, const void* K_new, int width_new,
                       int a_new, void* stream) {
  return with_width(width_old, [&](auto to) {
    return with_width(width_new, [&](auto tn) {
      return launch_anchor_diff(keys, old_out, new_out, moved, count,
                                anchor<decltype(to)>(A_old, K_old, a_old),
                                anchor<decltype(tn)>(A_new, K_new, a_new), stream);
    });
  });
}

int anchor_packed_replica(const void* keys, void* out, long long count, int k,
                          const void* load, int cap, const void* A, const void* K, int width,
                          int a, void* stream) {
  return with_width(width, [&](auto t) {
    return launch_replica(keys, out, count, k, load, cap, anchor<decltype(t)>(A, K, a),
                          stream);
  });
}

int anchor_packed_replica_diff(const void* keys, void* old_out, void* new_out, void* moved,
                               long long count, int k, const void* A_old, const void* K_old,
                               int width_old, int a_old, const void* A_new,
                               const void* K_new, int width_new, int a_new, void* stream) {
  return with_width(width_old, [&](auto to) {
    return with_width(width_new, [&](auto tn) {
      return launch_anchor_replica_diff(keys, old_out, new_out, moved, count, k,
                                        anchor<decltype(to)>(A_old, K_old, a_old),
                                        anchor<decltype(tn)>(A_new, K_new, a_new), stream);
    });
  });
}

int anchor_packed_walk(const void* chain, const void* probe, const void* pending, void* b,
                       void* chain_out, void* probe_out, long long count, const void* load,
                       int cap, int max_probe, const void* A, const void* K, int width, int a,
                       void* stream) {
  return with_width(width, [&](auto t) {
    return launch_walk(chain, probe, pending, b, chain_out, probe_out, count, load, cap,
                       max_probe, anchor<decltype(t)>(A, K, a), stream);
  });
}

int memento_compact_lookup(const void* keys, void* out, long long count,
                           const void* slot_b, const void* slot_c, int nslots, int n,
                           void* stream) {
  return launch_lookup(keys, out, count, memento_compact(slot_b, slot_c, nslots, n), stream);
}

int memento_compact_replica(const void* keys, void* out, long long count, int k,
                            const void* load, int cap, const void* slot_b, const void* slot_c,
                            int nslots, int n, void* stream) {
  return launch_replica(keys, out, count, k, load, cap,
                        memento_compact(slot_b, slot_c, nslots, n), stream);
}

// The lanes dx_lookup gives a key at this probe bound (dx_group), for
// the callers that report it.
int dx_lane_group(int max_probes) { return dx_group(max_probes); }

// The lanes dx_diff gives a key for these two epochs' probe bounds
// (dx_diff_group).
int dx_diff_lane_group(int max_probes_old, int max_probes_new) {
  return dx_diff_group(max_probes_old, max_probes_new);
}

// The lanes dx_replica gives a key at this probe bound (dx_replica_group).
int dx_replica_lane_group(int max_probes) { return dx_replica_group(max_probes); }

// The lanes dx_walk gives a walk lane at this probe bound (dx_walk_group).
int dx_walk_lane_group(int max_probes) { return dx_walk_group(max_probes); }

// The lanes dx_replica_diff gives a key in the epoch with more probes, for
// these two epochs' probe bounds (dx_replica_diff_group).
int dx_replica_diff_lane_group(int max_probes_old, int max_probes_new) {
  return dx_replica_diff_group(max_probes_old, max_probes_new);
}

// The check of anchor_replica_diff alone, over two dense AnchorHash epochs
// of one a, into kNestWords words at `work`: its verdict (0: the epochs do
// not nest, 1: the older epoch is the shallower, 2: the newer) and the
// shallower epoch's working count in work[0], work[1].  For timing it.
int anchor_nest_check(const void* A_old, const void* K_old, const void* A_new,
                      const void* K_new, int a, void* work, void* stream) {
  return launch_anchor_nest(anchor(A_old, K_old, a), anchor(A_new, K_new, a),
                            static_cast<NestWork*>(work), stream);
}

// The same check over two packed epochs of one a, each of its own width (1,
// 2 or 4 bytes): that of anchor_packed_diff and anchor_packed_replica_diff.
int anchor_packed_nest_check(const void* A_old, const void* K_old, int width_old,
                             const void* A_new, const void* K_new, int width_new, int a,
                             void* work, void* stream) {
  return with_width(width_old, [&](auto to) {
    return with_width(width_new, [&](auto tn) {
      return launch_anchor_nest(anchor<decltype(to)>(A_old, K_old, a),
                                anchor<decltype(tn)>(A_new, K_new, a),
                                static_cast<NestWork*>(work), stream);
    });
  });
}

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
