"""Encryption parameters (static, hashable).

Counterpart of ``hetpu/core/params.py``, kept identical (same chain
constructors, same presets, same primes) so that both packages agree on
every chain.
Replaces SEAL's ``EncryptionParameters`` + ``SEALContext`` parameter layer
(reference call sites: ``src/demos/matrix_operations.cpp:63-66``,
``math_operations.cpp:17-247``, ``fft.cpp:18-21``).

The reference hardcodes 26 modulus ladders by hand
(``math_operations.cpp:21-247``); here chains are generated from
(poly_degree, level count, prime bits) — SURVEY.md §2c explicitly asks for
this parameterization.

Deviations from SEAL (documented, deliberate):
  * all primes < 2^31 (32-bit residues) — SEAL's 40/60-bit
    primes become more 30/31-bit primes with the same total modulus budget;
  * hybrid key-switching with one special prime (SEAL's default scheme);
  * default CKKS scale 2^30 paired with ~2^30 rescale primes.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from enum import Enum
from functools import cached_property

from . import nt


class Scheme(str, Enum):
    CKKS = "ckks"
    BFV = "bfv"


@dataclass(frozen=True)
class HeParams:
    """Static parameter set. Frozen/hashable (usable as a cache key)."""

    scheme: Scheme
    poly_degree: int                       # N, power of two
    moduli: tuple[int, ...]                # RNS primes q_0..q_{L-1} (data primes)
    special_moduli: tuple[int, ...]        # key-switch primes p_0..p_{K-1}
    scale: float = 0.0                     # CKKS default scale (Δ)
    plain_modulus: int = 0                 # BFV t / 0 for CKKS
    # BFV batching: t = ∏ plain_factors, each an NTT-friendly prime ≡ 1
    # mod 2N (CRT batching — SEAL's 60-bit PlainModulus::Batching parity,
    # reference ``matrix_operations.cpp:360-361``).  Empty ⇒ t itself is
    # the single factor.  plain_batching=False allows ARBITRARY t (e.g.
    # the reference matpow demo's t = 2^32, ``matrix_operations.cpp:640``)
    # with coefficient (non-slot) encoding only.
    plain_factors: tuple[int, ...] = ()
    plain_batching: bool = True
    # CKKS: number of primes one rescale drops.  rescale_group=2 is the
    # paired-prime high-precision mode: scale ≈ q_a·q_b ≥ 2^44 on ≤31-bit
    # limbs — MATCHES/EXCEEDS the reference's scale-2^40 working precision
    # (``matrix_operations.cpp:845-852``) without 64-bit lanes.  The first
    # ``num_anchor`` primes are never rescaled away (the chain bottom must
    # exceed scale·|m| for decryption, SEAL's big first prime idiom).
    rescale_group: int = 1
    num_anchor: int = 1
    sec_level: int = 128

    def __post_init__(self):
        n = self.poly_degree
        if n & (n - 1) or n < 8:
            raise ValueError("poly_degree must be a power of two >= 8")
        for q in self.moduli + self.special_moduli:
            if q >= 1 << 31:
                raise ValueError("primes must be < 2^31 (32-bit residues)")
            if (q - 1) % (2 * n) != 0:
                raise ValueError(f"prime {q} not NTT-friendly for 2N={2*n}")
            if not nt.is_prime(q):
                raise ValueError(f"{q} is not prime")
        if len(set(self.moduli + self.special_moduli)) != len(self.moduli) + len(
            self.special_moduli
        ):
            raise ValueError("duplicate primes in modulus chain")
        total_bits = sum(q.bit_length() for q in self.moduli + self.special_moduli)
        if self.sec_level and total_bits > nt.max_coeff_modulus_bits(n, self.sec_level):
            raise ValueError(
                f"log2(QP)={total_bits} exceeds {self.sec_level}-bit security bound "
                f"{nt.max_coeff_modulus_bits(n, self.sec_level)} for N={n}; "
                "pass sec_level=0 to override (expert mode)"
            )
        if self.rescale_group not in (1, 2):
            raise ValueError("rescale_group must be 1 or 2")
        if (len(self.moduli) - self.num_anchor) % self.rescale_group != 0:
            raise ValueError("rescale primes above the anchors must be a "
                             "multiple of rescale_group")
        if self.scheme == Scheme.BFV:
            if self.plain_modulus == 0:
                raise ValueError("BFV requires plain_modulus")
            if self.plain_batching:
                factors = self.plain_factors or (self.plain_modulus,)
                prod = 1
                for f in factors:
                    prod *= f
                    if (f - 1) % (2 * n) != 0 or not nt.is_prime(f):
                        raise ValueError(
                            "batching plain factors must be primes "
                            f"= 1 mod 2N; got {f}")
                if prod != self.plain_modulus:
                    raise ValueError("plain_factors must multiply to "
                                     "plain_modulus")

    # ---- derived (host-side) quantities -------------------------------
    @property
    def num_levels(self) -> int:
        """Number of data primes L. chain_index of a fresh ct = L-1 … 0."""
        return len(self.moduli)

    @property
    def slot_count(self) -> int:
        return self.poly_degree // 2 if self.scheme == Scheme.CKKS else self.poly_degree

    @cached_property
    def q_total(self) -> int:
        x = 1
        for q in self.moduli:
            x *= q
        return x

    def q_at_level(self, level: int) -> int:
        """Product of active primes when `level+1` primes remain."""
        x = 1
        for q in self.moduli[: level + 1]:
            x *= q
        return x

    @cached_property
    def p_total(self) -> int:
        x = 1
        for p in self.special_moduli:
            x *= p
        return x

    def log_q(self) -> float:
        return sum(math.log2(q) for q in self.moduli)


# ----------------------------------------------------------------------
# Chain constructors
# ----------------------------------------------------------------------

def ckks_params(
    poly_degree: int,
    levels: int,
    *,
    scale_bits: int = 30,
    first_prime_bits: int = 31,
    special_prime_bits: int = 31,
    num_special: int = 1,
    sec_level: int = 128,
) -> HeParams:
    """CKKS chain: one larger anchor prime + `levels` rescale primes near
    2^scale_bits + special prime(s) for hybrid key-switching.

    Mirrors SEAL's {60, 40...40, 60} idiom (reference
    ``matrix_operations.cpp:845-852``) scaled to 31-bit lanes.

    ``scale_bits`` > 31 selects PAIRED-PRIME rescale (rescale_group=2):
    each of ``levels`` multiplicative levels is a pair (q_lo, q_hi) with
    q_lo·q_hi ≈ 2^scale_bits (e.g. 30+31 → scale ≈ 2^61 — beyond the
    reference's 2^40 working precision on 32-bit lanes).
    """
    two_n = 2 * poly_degree
    group = 1 if scale_bits <= 31 else 2
    if group == 1:
        # rescale primes as close to 2^scale_bits as possible
        mid = nt.gen_primes(scale_bits,
                            levels + (first_prime_bits == scale_bits), two_n)
        if first_prime_bits == scale_bits:
            anchors, mids = [mid[0]], list(mid[1:])
            used = set(mid)
        else:
            anchors = [nt.gen_primes(first_prime_bits, 1, two_n)[0]]
            mids = list(mid[:levels])
            used = {*anchors, *mids}
    else:
        if scale_bits > 61:
            raise ValueError("paired rescale supports scale_bits <= 61")
        # anchors: enough never-dropped primes that the chain bottom
        # exceeds scale·|m|·noise (≈18 bits of headroom)
        n_anchor = -(-(scale_bits + 18) // 31)
        anchors = list(nt.gen_primes(31, n_anchor, two_n)[:n_anchor])
        used = set(anchors)
        mids = []
        for lo, hi in _scale_pairs(scale_bits, levels, two_n, used):
            mids += [lo, hi]
    specials: list[int] = []
    cand = nt.gen_primes(special_prime_bits,
                         num_special + 2 * levels + 4, two_n)
    for p in cand:
        if p not in used and len(specials) < num_special:
            specials.append(p)
            used.add(p)
    return HeParams(
        scheme=Scheme.CKKS,
        poly_degree=poly_degree,
        moduli=(*anchors, *mids),
        special_moduli=tuple(specials),
        scale=float(2 ** scale_bits),
        rescale_group=group,
        num_anchor=len(anchors),
        sec_level=sec_level,
    )


def _scale_pairs(scale_bits: int, levels: int, two_n: int, used: set):
    """``levels`` prime pairs with q_lo·q_hi ≈ 2^scale_bits, drawn from a
    window of bit sizes around scale_bits/2 (greedy best-product match;
    ring degree decides which bit sizes have NTT primes at all).  Marks
    picked primes in ``used``."""
    import math
    half = scale_bits / 2
    lo_bit = max(int(half) - 6, two_n.bit_length() + 1)
    hi_bit = min(int(half) + 7, 31)
    # enumerate ALL NTT-friendly primes in the window (q = k·2N + 1)
    pool: list[int] = []
    q = (2 ** hi_bit - 1) // two_n * two_n + 1
    floor = 2 ** (lo_bit - 1)
    while q > floor:
        if q not in used and nt.is_prime(q):
            pool.append(q)
        q -= two_n
    pool.sort(reverse=True)
    pairs = []
    drift = 0.0          # accumulated log2(product) - scale_bits
    while len(pairs) < levels:
        if len(pool) < 2:
            raise ValueError(
                f"not enough NTT primes near 2^{half:.1f} for {levels} "
                f"scale-2^{scale_bits} pairs (2N={two_n})")
        p = pool.pop(0)
        target = scale_bits - drift      # steer products to cancel drift
        best_j, best_err = None, None
        for j, r in enumerate(pool):
            err = abs(math.log2(p) + math.log2(r) - target)
            if best_err is None or err < best_err:
                best_j, best_err = j, err
        if best_err > 0.3:
            continue              # no good partner for p — drop it
        r = pool.pop(best_j)
        drift += math.log2(p) + math.log2(r) - scale_bits
        pairs.append((min(p, r), max(p, r)))
        used.add(p)
        used.add(r)
    return pairs


def bfv_params(
    poly_degree: int,
    levels: int,
    *,
    plain_bits: int = 20,
    plain_modulus: int = 0,
    prime_bits: int = 30,
    first_prime_bits: int = 31,
    num_special: int = 1,
    sec_level: int = 128,
) -> HeParams:
    """BFV chain; ``plain_bits`` sized batching plaintext modulus
    (SEAL ``PlainModulus::Batching``, reference ``matrix_operations.cpp:148``).
    ``plain_bits`` > 31 builds t as a CRT product of ~30-bit NTT-friendly
    primes (60-bit batching-modulus parity, ``matrix_operations.cpp:360``).
    An explicit ``plain_modulus`` (e.g. 2^32, the reference matpow demo)
    disables batching and is used verbatim."""
    two_n = 2 * poly_degree
    first = nt.gen_primes(first_prime_bits, 1, two_n)[0]
    mids = nt.gen_primes(prime_bits, levels, two_n)[:levels]
    used = {first, *mids}
    specials = []
    for p in nt.gen_primes(31, levels + num_special + 3, two_n):
        if p not in used and len(specials) < num_special:
            specials.append(p)
            used.add(p)
    if plain_modulus:
        t, factors, batching = plain_modulus, (), False
    else:
        nf = -(-plain_bits // 30)
        bits_each = -(-plain_bits // nf)
        # the coeff-modulus mids draw from the same ≡1 mod 2N pool when
        # prime_bits == bits_each — request spares past them, but tolerate
        # pool exhaustion (small N has few primes ≡ 1 mod 2N at small bit
        # sizes); only the nf factors themselves are mandatory
        cand = [p for p in nt.gen_primes(bits_each, nf + levels + 6, two_n,
                                         strict=False)
                if p not in used]
        if len(cand) < nf:
            raise ValueError(
                f"not enough {bits_each}-bit batching primes = 1 mod {two_n} "
                f"disjoint from the coeff modulus: need {nf}, got {len(cand)}")
        factors = tuple(cand[:nf])
        t = 1
        for f in factors:
            t *= f
        batching = True
    return HeParams(
        scheme=Scheme.BFV,
        poly_degree=poly_degree,
        moduli=(first, *mids),
        special_moduli=tuple(specials),
        plain_modulus=t,
        plain_factors=factors if len(factors) > 1 else (),
        plain_batching=batching,
        sec_level=sec_level,
    )


# ----------------------------------------------------------------------
# Named presets mirroring each reference demo's hardcoded parameters
# (SURVEY.md §5 "Config / flag system": the build should have named presets)
# ----------------------------------------------------------------------

def preset(name: str) -> HeParams:
    return _PRESETS[name]()


_PRESETS = {
    # reference matrix_operations.cpp:63-66  — CKKS N=2^13 {60,40,40,60}
    "ckks_small": lambda: ckks_params(1 << 13, levels=2, scale_bits=30,
                                     num_special=2),
    # reference matrix_operations.cpp:840-852 — CKKS N=2^15, 15 levels
    "ckks_deep": lambda: ckks_params(1 << 15, levels=15, scale_bits=30,
                                    num_special=4),
    # reference fft.cpp:18-21 — CKKS N=2^14, 10 levels
    "ckks_fft": lambda: ckks_params(1 << 14, levels=10, scale_bits=30,
                                   num_special=3),
    # BASELINE.json config 1: N=8192, 3 RNS primes
    "baseline_roundtrip": lambda: ckks_params(1 << 13, levels=2, scale_bits=30),
    # north-star bench config: N=2^14.  α=5 special primes → J=2 key-switch
    # digits: 22% fewer inner-product MACs and 12% fewer NTT planes per
    # relinearization than α=3, still within the 128-bit bound
    # (log QP = 426 ≤ 438 at N=2^14).
    "bench_n14": lambda: ckks_params(1 << 14, levels=8, scale_bits=30,
                                    num_special=5),
    # α=4 variant: uniform digit sizes (4,4) make the foreign basis 16
    # rows instead of 18 and R=12 instead of 13 (fewer key-switch NTT
    # planes and MACs); P/D margin ~2^3 — fine at 2^-10 precision
    "bench_n14_a4": lambda: ckks_params(1 << 14, levels=8, scale_bits=30,
                                        num_special=4),
    # all-primes-<2^30 variant (scale 2^29, 30-bit first/special primes):
    # every NTT basis qualifies for the 3-multiply approximate-mulhi
    # Shoup path (mxu_ntt._shoup_scalarish fast branch — exact for
    # q < 2^30)
    "bench_n14_fast": lambda: ckks_params(1 << 14, levels=8, scale_bits=29,
                                          num_special=4,
                                          first_prime_bits=30,
                                          special_prime_bits=30),
    # HIGH-PRECISION pair-rescale: scale ≈ 2^44 (beats the reference's
    # 2^40, matrix_operations.cpp:63-66) at the same N=2^13 / depth 2
    "ckks_hi": lambda: ckks_params(1 << 13, levels=2, scale_bits=44,
                                   num_special=2),
    # N=2^14 high-precision, depth 5 @ 2^44, α=3 keyswitch
    "ckks_hi14": lambda: ckks_params(1 << 14, levels=5, scale_bits=44,
                                     num_special=3),
    # deep high-precision chain, N=2^15, depth 11 @ 2^55
    "ckks_deep_hi": lambda: ckks_params(1 << 15, levels=11, scale_bits=55,
                                        num_special=4),
    # FLAGSHIP precision config (VERDICT r3 item 4): fft at reference
    # depth (fft.cpp:18-21 is 10 levels) but scale 2^55 ≫ the reference's
    # 2^40 working precision (matrix_operations.cpp:845-852); N=2^15
    # because ten 55-bit levels exceed the 128-bit bound at 2^14.  (The
    # least-squares flagship reuses ckks_deep_hi: depth 11 = exactly the
    # pipeline's consumption at inv_iters=6.)
    "ckks_fft_hi": lambda: ckks_params(1 << 15, levels=10, scale_bits=55,
                                       num_special=4),
    # reference matrix_operations.cpp:145-150 — BFV N=2^13
    "bfv_small": lambda: bfv_params(1 << 13, levels=2),
    # reference matrix_operations.cpp:360-361 — 60-bit CRT batching
    # modulus (PlainModulus::Batching(poly, 60)).  N=2^14 instead of the
    # reference's 2^13: batching smears slot values across full-range
    # coefficients mod t, so fresh invariant noise ≈ t²/Q and ONE
    # multiply consumes ~log2(2tN) ≈ 75 bits — with t=2^60 that needs
    # log2(Q) ≳ 200, beyond the 128-bit bound at N=2^13 (the reference
    # demo's budget hits 0 there; SEAL's own defaults included).
    # Q = 31+6·30 = 211 bits → ~89 bits fresh, ~12 left after a 5×5
    # matmul — exact.
    "bfv_batch": lambda: bfv_params(1 << 14, levels=6, plain_bits=60,
                                    num_special=2),
    # reference matrix_operations.cpp:640-641 — BFV, t = 2^32
    # (non-batching element-per-ct matpow).  N=2^14 instead of the
    # reference's 2^13: A⁵ is depth 3, and depth-3 noise at t=2^32
    # (~48 bits/level) needs Δ = Q/t ≈ 2^179 — more headroom than the
    # 128-bit security bound allows at N=2^13 with 31-bit limbs.
    "bfv_matpow": lambda: bfv_params(1 << 14, levels=6,
                                     plain_modulus=1 << 32, num_special=2),
    # tiny fast-test configs (sec_level=0: test-only, too small to be secure)
    "test_tiny": lambda: ckks_params(1 << 10, levels=2, scale_bits=30,
                                     first_prime_bits=31, special_prime_bits=31,
                                     sec_level=0),
    # deep chain for iterative-math / fft tests
    "test_deep": lambda: ckks_params(1 << 11, levels=12, scale_bits=30,
                                     first_prime_bits=31, special_prime_bits=31,
                                     sec_level=0),
    # tiny pair-rescale high-precision config (scale ≈ 2^44)
    "test_hi": lambda: ckks_params(1 << 10, levels=3, scale_bits=44,
                                   sec_level=0),
    # multi-prime-digit (dnum) key-switch coverage: α = 3 special primes
    "test_dnum": lambda: ckks_params(1 << 10, levels=7, scale_bits=30,
                                     first_prime_bits=31, special_prime_bits=31,
                                     num_special=3, sec_level=0),
    "test_bfv_tiny": lambda: bfv_params(1 << 10, levels=2, plain_bits=17,
                                        prime_bits=26, first_prime_bits=27,
                                        sec_level=0),
    # CRT plain modulus (t = t1·t2 ≈ 2^34) + enough levels for a dropped-
    # level multiply
    "test_bfv_crt": lambda: bfv_params(1 << 10, levels=5, plain_bits=34,
                                       prime_bits=29, first_prime_bits=30,
                                       sec_level=0),
    # depth-3 capable non-batching chain (A⁵ matpow at test scale):
    # noise/level ≈ log2(t·N·2) = 28 bits, Δ = 2^141 covers depth 3
    "test_bfv_pow": lambda: bfv_params(1 << 10, levels=5,
                                       plain_modulus=1 << 16,
                                       prime_bits=26, first_prime_bits=27,
                                       sec_level=0),
    # non-batching scalar coefficients, t = 2^20 (matpow-style)
    "test_bfv_scalar": lambda: bfv_params(1 << 10, levels=2,
                                          plain_modulus=1 << 20,
                                          prime_bits=27, first_prime_bits=28,
                                          sec_level=0),
}


def chain_sweep(poly_degree: int = 1 << 15, min_levels: int = 2,
                max_levels: int = 26, sec_level: int = 128):
    """Yield (levels, params) like the reference's chain_levels 2..26 sweep
    (``math_operations.cpp:614-619``) — one generator instead of 26
    hand-built ladders (SURVEY.md §2c)."""
    for lv in range(min_levels, max_levels + 1):
        try:
            yield lv, ckks_params(poly_degree, levels=lv, scale_bits=30,
                                  sec_level=sec_level)
        except ValueError:
            return
