"""K1: counter-based Threefry-2x32 streams, the eager twin.

Port of ``_threefry2x32``, ``_uniform32``, ``_draw8``, ``_photon_keys``
and ``_key_words`` (pvtrace_tpu/engine/tracer.py). Streams are labelled
by counters, so every draw is a pure function of (seed, photon id, the
photon's own step counter):

    photon key  (pk0, pk1) = threefry(seed, pid, 0)
    step draws  u[2j], u[2j+1] = threefry(pk, count, j), j = 0..3
    emission    e[2j], e[2j+1] = threefry(pk, 0, 16 + j), j = 0..2

Words are int64 tensors holding values in [0, 2**32): PyTorch's CPU
build has no uint32 add, shift or compare, so the twin computes in int64
masked to 32 bits. The CUDA kernels use native uint32 and give the same
bits.
"""
import torch

MASK32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def key_words(seed):
    """Seed words of ``jax.random.PRNGKey(seed)`` for a uint32 seed."""
    seed = int(seed)
    if not 0 <= seed <= MASK32:
        raise ValueError(f"seed must be in [0, 2**32), got {seed}")
    return 0, seed


def _rotl(x, d):
    return ((x << d) | (x >> (32 - d))) & MASK32


def threefry2x32(k0, k1, c0, c1):
    """Threefry-2x32, 20 rounds; the same bits as jax's generator.

    Arguments are int64 tensors (or python ints) of 32-bit words."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (c0 + ks[0]) & MASK32
    x1 = (c1 + ks[1]) & MASK32
    for r in range(5):
        for rot in _ROT[r % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, rot) ^ x0
        x0 = (x0 + ks[(r + 1) % 3]) & MASK32
        x1 = (x1 + ks[(r + 2) % 3] + (r + 1)) & MASK32
    return x0, x1


def uniform32(bits, dtype):
    """Uniform in [0, 1): the float32 value in [1, 2) made from the top 23
    bits, cast to `dtype`, minus 1 (jax's construction)."""
    fbits = (bits >> 9) | 0x3F800000
    return fbits.to(torch.int32).view(torch.float32).to(dtype) - 1.0


def draw(k0, k1, counter, first, n, dtype):
    """2n uniforms from counters (counter, first + j), j < n."""
    out = []
    for j in range(n):
        w0, w1 = threefry2x32(k0, k1, counter, torch.full_like(counter, first + j))
        out.append(uniform32(w0, dtype))
        out.append(uniform32(w1, dtype))
    return out


def draw8(k0, k1, counter, dtype):
    """The eight step uniforms of each lane (counter = step count)."""
    return draw(k0, k1, counter, 0, 4, dtype)


def photon_keys(seed_words, pids):
    """Photon keys threefry(seed, pid, 0) for int64 photon ids."""
    s0, s1 = seed_words
    return threefry2x32(s0, s1, pids, torch.zeros_like(pids))


WARP = 32


def warp_draws(seed_words, base, dead, need, k0, k1, count, mask, dtype=torch.float32):
    """The plain twin of ``pvt_draws`` (kernels/csrc/tracer.cu): B lanes,
    each WARP of them a warp. Per warp w a refill: its dead lanes (`dead`,
    bool [B]) take photons base[w] + their rank among them, their keys
    threefry(seed, (pid, 0)) and the emission pairs of `need` (bit j: pair
    j, threefry(key, (0, 16 + j))). Per lane the step words of `mask` (bit
    k: word k of ``draw8``) with key (k0, k1) at step `count`. Returns
    (keys [B, 2] int64, 0 on live lanes; emit [B, 6] and words [B, 8], -1
    where not drawn or not in the mask; calls [B / WARP] int32: the
    threefry calls each warp's refill should make, the key's and one a
    pair of `need` where a lane refills, else 0, which the kernel counts
    where it makes them)."""
    dead, count, mask = dead.bool(), count.long(), mask.long()
    d = dead.view(-1, WARP).long()
    pk0, pk1 = photon_keys(seed_words, (base.view(-1, 1) + torch.cumsum(d, 1) - d).reshape(-1))
    live = ~dead
    keys = torch.stack([pk0.masked_fill(live, 0), pk1.masked_fill(live, 0)], 1)
    emit = torch.full((dead.numel(), 6), -1.0, dtype=dtype, device=dead.device)
    for j in range(3):
        if need >> j & 1:
            w0, w1 = threefry2x32(pk0, pk1, torch.zeros_like(pk0), torch.full_like(pk0, 16 + j))
            emit[:, 2 * j] = torch.where(dead, uniform32(w0, dtype), -1.0)
            emit[:, 2 * j + 1] = torch.where(dead, uniform32(w1, dtype), -1.0)
    u = draw8(k0, k1, count, dtype)
    words = torch.stack([torch.where((mask >> k) & 1 == 1, u[k], -1.0) for k in range(8)], 1)
    calls = torch.where(d.sum(1) > 0, 1 + bin(need).count("1"), 0).int()
    return keys, emit, words, calls
