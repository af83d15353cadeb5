"""Bit-exact replication of Julia's seeded ``MersenneTwister`` streams.

The reference seeds a fresh ``MersenneTwister(Int(rng))`` inside
``rand_func_cont`` / ``rand_func_int`` (``HelpFunctions.jl:159``
and ``:206``), so a reference run with a *given* seed is reproducible — but
only if the consumer replicates Julia's RNG bit-for-bit.  numpy's MT19937 is
a different generator (Julia uses **dSFMT-19937**), so round 1 documented the
divergence as unavoidable.  This module removes it: it implements

* the dSFMT-19937 core (SIMD-oriented Fast Mersenne Twister of Saito &
  Matsumoto — the generator behind ``Base.Random.MersenneTwister``):
  recursion, ``init_by_array`` seeding, period certification, and the
  *array*-generation path (which differs from repeated state reads),
* Julia's integer seeding (``Random.make_seed`` → ``dsfmt_init_by_array``),
* Julia's 382-value ``Float64`` cache semantics (``MT_CACHE_F`` pops vs the
  direct ``fill_array!`` bulk path used for arrays of length ≥ 382),
* the samplers the reference consumes: ``rand()`` in ``[0,1)``,
  ``SamplerRangeFast`` for unit ranges / array indexing (52-bit mask +
  rejection), the ziggurat ``randn`` (scalar and MersenneTwister's bulk
  array path), and StatsBase's ordered sampling without replacement
  (``seqsample_a!`` / ``seqsample_c!``).

Golden verification: the first draws of ``MersenneTwister(0)`` /
``MersenneTwister(1234)`` are published constants (Julia documentation and
release-stability guarantees); ``tests/test_julia_rng.py`` asserts them to
the last bit, which pins the core recursion, the seeding and the cache
order all at once.

Transcription notes (all structures re-derived, no Julia source shipped):
* dSFMT parameters are the published 19937 set (pos1=117, sl1=19, sr=12,
  msk/fix/pcv constants from the dSFMT reference implementation).
* The ziggurat tables are *generated* here by the same construction the
  published tables use (256 strips, r=3.6541528853610088, section area
  4.92867323399e-3, 51-bit mantissa scaling).  Table generation uses libm
  ``exp``/``log``/``sqrt``; should a platform libm differ from the values
  Julia hardcodes in its last ulp, an affected strip could select a
  different branch for boundary draws.  The common (99.3%) path is pure
  table lookup × multiply and carries no such risk.
* ``DSP.conv`` (used by the reference's ``rand_func_cont`` smoothing) is
  FFT-based; the *noise* ``ξ`` replicated here is bit-exact, the smoothed
  control matches up to convolution rounding (~1e-12 relative).

Everything is plain Python integers / numpy float64 on the host — this is
start-point generation, never on the device solve path.
"""

from __future__ import annotations

import math
import struct
from typing import List, Sequence

import numpy as np

__all__ = ["JuliaMersenneTwister"]

_M64 = (1 << 64) - 1
_M32 = (1 << 32) - 1

# dSFMT-19937 parameters (published reference set).
_N = 191                      # (19937 - 128) // 104 + 1 : 128-bit state words
_N64 = 2 * _N                 # doubles per state block = 382
_POS1 = 117
_SL1 = 19
_SR = 12
_MSK1 = 0x000FFAFFFFFFFB3F
_MSK2 = 0x000FFDFFFC90FFFD
_FIX1 = 0x90014964B32F4329
_FIX2 = 0x3B8D12AC548A7C7A
_PCV1 = 0x3D84E1AC0DC82880
_PCV2 = 0x0000000000000001
_LOW_MASK = 0x000FFFFFFFFFFFFF
_HIGH_CONST = 0x3FF0000000000000

# Julia's MersenneTwister Float64 cache size (= dsfmt min array size).
_MT_CACHE_F = _N64

# Ziggurat constants (256-strip normal ziggurat, as used by Julia's randn).
_ZIG_NOR_R = 3.6541528853610088
_ZIG_NOR_INV_R = 1.0 / _ZIG_NOR_R
_NOR_SECTION_AREA = 0.00492867323399
_NMANTISSA = 2251799813685248.0  # 2^51


def _make_ziggurat_tables():
    """256-strip normal ziggurat tables (ki: UInt64 accept bounds, wi: strip
    widths scaled by 2^-51, fi: pdf values), by the standard construction."""
    ki = [0] * 256
    wi = [0.0] * 256
    fi = [0.0] * 256
    x1 = _ZIG_NOR_R
    wi[255] = x1 / _NMANTISSA
    fi[255] = math.exp(-0.5 * x1 * x1)
    ki[0] = int(x1 * fi[255] / _NOR_SECTION_AREA * _NMANTISSA)
    wi[0] = _NOR_SECTION_AREA / fi[255] / _NMANTISSA
    fi[0] = 1.0
    for i in range(254, 0, -1):
        x = math.sqrt(-2.0 * math.log(_NOR_SECTION_AREA / x1 + fi[i + 1]))
        ki[i + 1] = int(x / x1 * _NMANTISSA)
        wi[i] = x / _NMANTISSA
        fi[i] = math.exp(-0.5 * x * x)
        x1 = x
    ki[1] = 0
    return ki, wi, fi


_KI, _WI, _FI = _make_ziggurat_tables()


def _u64_to_f64(bits: int) -> float:
    return struct.unpack("<d", struct.pack("<Q", bits))[0]


def _swap32(x: int) -> int:
    return ((x >> 32) | (x << 32)) & _M64


def _make_seed(n: int) -> List[int]:
    """Julia ``Random.make_seed(n::Integer)``: little-endian UInt32 limbs."""
    if n < 0:
        raise ValueError("seed must be non-negative")
    seed = []
    while True:
        seed.append(n & _M32)
        n >>= 32
        if n == 0:
            return seed


class JuliaMersenneTwister:
    """Bit-exact model of ``Julia Random.MersenneTwister(seed)``.

    Exposes exactly the draw methods the reference's start-generation
    consumes; every method advances the stream the same way Julia does
    (Float64 cache pops vs direct array fills included).
    """

    def __init__(self, seed: int = 0):
        # state: (N+1) 128-bit words as 2*(N+1) uint64; the last pair is the lung.
        self._s: List[int] = [0] * (2 * (_N + 1))
        self._seed_by_array(_make_seed(int(seed)))
        self._cache: List[float] = []
        self._cache_idx = 0  # == len(cache) means empty

    # ---- dSFMT core -----------------------------------------------------

    def _seed_by_array(self, key: Sequence[int]) -> None:
        # 32-bit little-endian view of the (N+1) 128-bit state words.
        size = (_N + 1) * 4
        p32 = [0x8B8B8B8B] * size

        def f1(x):
            return ((x ^ (x >> 27)) * 1664525) & _M32

        def f2(x):
            return ((x ^ (x >> 27)) * 1566083941) & _M32

        lag = 11 if size >= 623 else 7 if size >= 68 else 5 if size >= 39 else 3
        mid = (size - lag) // 2
        count = max(len(key) + 1, size)

        r = f1(p32[0] ^ p32[mid % size] ^ p32[(size - 1) % size])
        p32[mid % size] = (p32[mid % size] + r) & _M32
        r = (r + len(key)) & _M32
        p32[(mid + lag) % size] = (p32[(mid + lag) % size] + r) & _M32
        p32[0] = r
        count -= 1
        i, j = 1, 0
        while j < count and j < len(key):
            r = f1(p32[i] ^ p32[(i + mid) % size] ^ p32[(i + size - 1) % size])
            p32[(i + mid) % size] = (p32[(i + mid) % size] + r) & _M32
            r = (r + key[j] + i) & _M32
            p32[(i + mid + lag) % size] = (p32[(i + mid + lag) % size] + r) & _M32
            p32[i] = r
            i = (i + 1) % size
            j += 1
        while j < count:
            r = f1(p32[i] ^ p32[(i + mid) % size] ^ p32[(i + size - 1) % size])
            p32[(i + mid) % size] = (p32[(i + mid) % size] + r) & _M32
            r = (r + i) & _M32
            p32[(i + mid + lag) % size] = (p32[(i + mid + lag) % size] + r) & _M32
            p32[i] = r
            i = (i + 1) % size
            j += 1
        for _ in range(size):
            r = f2((p32[i] + p32[(i + mid) % size] + p32[(i + size - 1) % size]) & _M32)
            p32[(i + mid) % size] ^= r
            r = (r - i) & _M32
            p32[(i + mid + lag) % size] ^= r
            p32[i] = r
            i = (i + 1) % size

        # pack little-endian uint32 pairs into uint64 words
        s = self._s
        for w in range(2 * (_N + 1)):
            s[w] = p32[2 * w] | (p32[2 * w + 1] << 32)

        # initial_mask: force the IEEE [1,2) exponent pattern (lung excluded)
        for w in range(2 * _N):
            s[w] = (s[w] & _LOW_MASK) | _HIGH_CONST

        # period certification on the lung
        t0 = s[2 * _N] ^ _FIX1
        t1 = s[2 * _N + 1] ^ _FIX2
        inner = (t0 & _PCV1) ^ (t1 & _PCV2)
        k = 32
        while k > 0:
            inner ^= inner >> k
            k >>= 1
        if (inner & 1) != 1:
            s[2 * _N + 1] ^= 1  # PCV2 & 1 == 1 branch

    def _gen_block(self, size_w128: int) -> List[int]:
        """dSFMT array generation (close1_open2 layout): return ``size_w128``
        128-bit words as a flat uint64 list and advance the state.  Mirrors
        the reference generator's array path, which is NOT the same as
        repeatedly regenerating the state in place."""
        if size_w128 < _N:
            raise ValueError("array size below dSFMT minimum")
        s = self._s
        L0, L1 = s[2 * _N], s[2 * _N + 1]
        out = [0] * (2 * size_w128)

        def rec(i, a0, a1, b0, b1, L0, L1):
            nL0 = ((a0 << _SL1) & _M64) ^ _swap32(L1) ^ b0
            nL1 = ((a1 << _SL1) & _M64) ^ _swap32(L0) ^ b1
            out[2 * i] = (nL0 >> _SR) ^ (nL0 & _MSK1) ^ a0
            out[2 * i + 1] = (nL1 >> _SR) ^ (nL1 & _MSK2) ^ a1
            return nL0, nL1

        for i in range(_N - _POS1):
            L0, L1 = rec(i, s[2 * i], s[2 * i + 1],
                         s[2 * (i + _POS1)], s[2 * (i + _POS1) + 1], L0, L1)
        for i in range(_N - _POS1, _N):
            j = i + _POS1 - _N
            L0, L1 = rec(i, s[2 * i], s[2 * i + 1], out[2 * j], out[2 * j + 1], L0, L1)
        for i in range(_N, size_w128):
            L0, L1 = rec(i, out[2 * (i - _N)], out[2 * (i - _N) + 1],
                         out[2 * (i + _POS1 - _N)], out[2 * (i + _POS1 - _N) + 1], L0, L1)
        # copy the tail of the output back into the state
        for j in range(_N):
            i = j + size_w128 - _N
            s[2 * j] = out[2 * i]
            s[2 * j + 1] = out[2 * i + 1]
        s[2 * _N], s[2 * _N + 1] = L0, L1
        return out

    def _fill_close1_open2(self, n: int) -> List[float]:
        """``n`` doubles in [1,2) via the direct array path (n even, ≥ 382).
        Advances the dSFMT state; does NOT touch the Float64 cache."""
        assert n % 2 == 0 and n >= _N64
        return [_u64_to_f64(b) for b in self._gen_block(n // 2)]

    # ---- Julia Float64 cache semantics ----------------------------------

    def _pop12(self) -> float:
        """One cached double in [1,2) — Julia's ``rand_inbounds(r, CloseOpen12())``."""
        if self._cache_idx >= len(self._cache):
            self._cache = self._fill_close1_open2(_MT_CACHE_F)
            self._cache_idx = 0
        v = self._cache[self._cache_idx]
        self._cache_idx += 1
        return v

    def rand(self) -> float:
        """Julia ``rand(r)``: Float64 in [0,1)."""
        return self._pop12() - 1.0

    def rand_uint52raw(self) -> int:
        """Julia ``rand(r, UInt52Raw())``: raw bits of a cached [1,2) double."""
        return struct.unpack("<Q", struct.pack("<d", self._pop12()))[0]

    # ---- range / array-index samplers -----------------------------------

    def rand_range(self, first: int, last: int) -> int:
        """Julia ``rand(r, first:last)`` — ``SamplerRangeFast``: mask the low
        ``bw`` bits of UInt52Raw draws, reject until ≤ span."""
        if last < first:
            raise ValueError("empty range")
        m = last - first
        bw = m.bit_length()
        mask = (1 << bw) - 1
        if bw > 52:  # not needed by the reference shapes; masked-uniform path
            raise NotImplementedError("ranges wider than 2^52 are not used")
        while True:
            x = self.rand_uint52raw() & mask
            if x <= m:
                return first + x

    def rand_index(self, n: int) -> int:
        """Julia ``rand(r, v::Vector)`` index draw: 0-based index into n items."""
        return self.rand_range(1, n) - 1

    # ---- randn (ziggurat) ------------------------------------------------

    def _randn_from_bits(self, r: int) -> float:
        r &= _LOW_MASK
        rabs = r >> 1  # 51 bits
        idx = rabs & 0xFF
        # Julia negates the INTEGER rabs (ifelse(r % Bool, -rabs, rabs)), so a
        # rabs == 0 draw yields +0.0 regardless of the sign bit — negate the
        # int, not the float, to keep even that 2^-51 case bit-identical.
        x = float(-rabs if (r & 1) else rabs) * _WI[idx]
        if rabs < _KI[idx]:
            return x
        return self._randn_unlikely(idx, rabs, x)

    def _randn_unlikely(self, idx: int, rabs: int, x: float) -> float:
        if idx == 0:
            # math.log(0.0) raises in Python but is -Inf in Julia; a zero
            # uniform (2^-52 per draw) must reject the sample, not crash.
            _log = lambda v: math.log(v) if v > 0.0 else -math.inf
            while True:
                xx = -_ZIG_NOR_INV_R * _log(self.rand())
                yy = -_log(self.rand())
                if yy + yy > xx * xx:
                    return -_ZIG_NOR_R - xx if (rabs >> 8) & 1 else _ZIG_NOR_R + xx
        elif (_FI[idx - 1] - _FI[idx]) * self.rand() + _FI[idx] < math.exp(-0.5 * x * x):
            return x
        return self.randn()

    def randn(self) -> float:
        """Julia scalar ``randn(r)``: 256-strip ziggurat on 52 fresh bits."""
        return self._randn_from_bits(self.rand_uint52raw())

    def randn_array(self, n: int) -> np.ndarray:
        """Julia ``randn(r, Float64, n)`` for MersenneTwister: for n ≥ 13 the
        array is first bulk-filled with [1,2) uniforms (direct dSFMT array
        fill for the largest even prefix ≥ 382, cache pops for the rest),
        then each value's mantissa bits are mapped through the ziggurat with
        rejection draws taken from the live stream."""
        if n < 13:
            return np.array([self.randn() for _ in range(n)])
        u = self._rand12_array(n)
        out = np.empty(n)
        for i in range(n):
            bits = struct.unpack("<Q", struct.pack("<d", u[i]))[0]
            out[i] = self._randn_from_bits(bits)
        return out

    def _rand12_array(self, n: int) -> List[float]:
        """Julia ``rand!(r, A, CloseOpen12())``: direct array fill for the
        largest even prefix when it meets the dSFMT minimum (fresh Julia
        ``Vector{Float64}`` allocations are 16-byte aligned), remainder from
        the cache."""
        m2 = n - (n % 2)
        if m2 >= _N64:
            vals = self._fill_close1_open2(m2)
            vals.extend(self._pop12() for _ in range(n - m2))
            return vals
        return [self._pop12() for _ in range(n)]

    def rand_array(self, n: int) -> np.ndarray:
        """Julia ``rand(r, n)``: uniforms in [0,1) with array-fill semantics."""
        return np.array(self._rand12_array(n)) - 1.0

    # ---- StatsBase ordered sampling without replacement ------------------

    def seqsample_a(self, pool: Sequence, k: int) -> list:
        """StatsBase ``seqsample_a!`` (Vitter's Algorithm A): ordered sample
        of k items without replacement, one uniform per accepted item."""
        n = len(pool)
        if k > n:
            raise ValueError("cannot draw more samples than the pool size")
        out = []
        i = 0
        while k > 1:
            u = self.rand()
            q = (n - k) / n
            while q > u:
                i += 1
                n -= 1
                q *= (n - k) / n
            out.append(pool[i])
            i += 1
            n -= 1
            k -= 1
        if k > 0:
            s = int(n * self.rand())
            out.append(pool[i + s])
        return out

    def seqsample_c(self, pool: Sequence, k: int) -> list:
        """StatsBase ``seqsample_c!`` (Algorithm C of Vitter, "Faster methods
        for random sampling", CACM 27(7) 1984, p. 715): ordered sample of k
        items without replacement.

        Per output item the skip ``s`` to the next selected element is drawn
        as ``⌊min(l, min_{u=l..N} u·Uᵤ)⌋ + 1`` with ``l = N − n + 1`` and the
        uniforms consumed for ``u = N, N−1, …, l`` in that order — the
        capped running minimum of ``u·Uᵤ`` has ``P(min > s) =
        ∏_{u=l}^{N} (u−s)/u``, exactly the ordered-sampling skip law
        ``P(S > s) = ∏_{j=0}^{n−1} (N−j−s)/(N−j)``.  The last item is a
        single uniform index over the remainder.  Draw order and update
        structure follow StatsBase's implementation (``sampling.jl``
        ``seqsample_c!``), so the consumed stream matches Julia's for the
        ``n > 10k²`` regime that selects this algorithm."""
        n = len(pool)
        if k > n:
            raise ValueError("cannot draw more samples than the pool size")
        out = []
        i = 0  # 0-based count of consumed pool prefix
        kk, N = k, n
        while kk > 1:
            l = N - kk + 1
            minv = float(l)
            u = N
            while u >= l:
                v = u * self.rand()
                if v < minv:
                    minv = v
                u -= 1
            s = int(minv) + 1  # trunc toward zero; minv ∈ [0, l)
            i += s
            out.append(pool[i - 1])
            N -= s
            kk -= 1
        if kk > 0:
            s = int(N * self.rand())
            out.append(pool[i + s])
        return out

    def sample_ordered(self, pool: Sequence, k: int) -> list:
        """StatsBase ``sample(r, pool, k; replace=false, ordered=true)``.

        StatsBase selects Vitter's Algorithm A for ``n ≤ 10k²`` — the regime
        every reference default hits (``jumps = nt ÷ 10`` gives
        ``n = nt−1 ≤ nt²/10`` for all ``nt ≥ 11``) — and the Algorithm-C
        sampler above for ``n > 10k²`` (user-supplied tiny ``jumps``),
        mirroring ``StatsBase.sampling.jl``'s branch."""
        n = len(pool)
        if n > 10 * k * k:
            return self.seqsample_c(pool, k)
        return self.seqsample_a(pool, k)
