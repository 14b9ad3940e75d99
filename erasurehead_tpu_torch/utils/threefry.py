"""JAX's counter-based RNG (threefry2x32) in plain PyTorch.

The JAX package draws the on-device trainer's arrivals as
``delay_mean * jax.random.exponential(fold_in(key(seed + 1), round), (W,))``
(erasurehead_tpu/parallel/dynamic.py, straggler.jax_delay_schedule). This
module computes the same numbers, so the port's on-device trajectory can be
held against JAX's:

  - :func:`threefry2x32`: the Threefry-2x32 block cipher with 20 rounds
    (rotations 13, 15, 26, 6 / 17, 29, 16, 24; key schedule with the parity
    constant 0x1BD11BDA), on int64 tensors holding 32-bit words;
  - :func:`key` and :func:`fold_in`: a key is the word pair
    ``(seed >> 32, seed & 0xFFFFFFFF)`` and ``fold_in(k, d)`` enciphers the
    pair ``(0, d)`` under ``k``. Keys are Python ints, folded in on the host
    in integer arithmetic: a key is two words, and the per-round key is a
    function of the seed and the round index, both of which the host
    already holds;
  - :func:`random_bits`: JAX's partitionable bits (its default): element
    ``i`` of the flat shape enciphers the counter ``(i >> 32, i & 0xFFFFFFFF)``
    and keeps ``x0 ^ x1``;
  - :func:`uniform` (``(bits >> 9) | 0x3F800000`` read as float32, minus 1)
    and :func:`exponential` (``-log1p(-u)``), in float32.

The bits are equal to JAX's bit for bit; the exponentials differ by the
last-ulp rounding of ``log1p`` (about 1e-7 relative). Every tensor op takes
the key words as Python scalars, so a draw on the card makes no host copy
and no synchronisation.

Batched draws: :func:`random_bits`, :func:`uniform` and :func:`exponential`
also take a ``[K, 2]`` int64 tensor of keys (:func:`key_tensor`) and return
``[K, n]``, row k equal to the draw under key k. The key words then ride
the cipher as ``[K, 1]`` columns, so the whole block is one pass of the
same elementwise ops: the launch count does not grow with K (the what-if
sampler draws every (seed, round) of a Monte-Carlo block at once).
"""

from __future__ import annotations

import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _word(k):
    return k & _MASK if isinstance(k, torch.Tensor) else int(k) & _MASK


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 of the counter words ``(x0, x1)`` (int64 tensors, or
    Python ints, with values in [0, 2^32)) under the key ``(k0, k1)``
    (Python ints, or int64 tensors broadcasting against the counters);
    returns the two enciphered words in [0, 2^32), of the counters' kind.

    Word arithmetic is mod 2^32 in int64: ``x0`` carries its bits above 32
    unmasked until the end (they never reach the low word through adds,
    and ``x1`` is masked after each xor with it), which saves a launch a
    round on the card."""
    k0, k1 = _word(k0), _word(k1)
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = x0 + ks[0]
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = (((x1 << r) | (x1 >> (32 - r))) ^ x0) & _MASK
        x0 = x0 + ks[(i + 1) % 3]
        x1 = (x1 + (ks[(i + 2) % 3] + i + 1)) & _MASK
    return x0 & _MASK, x1


def key(seed: int) -> tuple[int, int]:
    """``jax.random.key(seed)`` of the default threefry implementation."""
    seed = int(seed)
    return (seed >> 32) & _MASK, seed & _MASK


def fold_in(k: tuple[int, int], data: int) -> tuple[int, int]:
    """``jax.random.fold_in(k, data)``: the key enciphering ``(0, data)``."""
    return threefry2x32(k[0], k[1], 0, int(data) & _MASK)


def key_tensor(keys, device=None) -> torch.Tensor:
    """``[K, 2]`` int64 key words of a list of keys (host ints), for the
    batched draws."""
    return torch.tensor([[int(k0), int(k1)] for k0, k1 in keys], dtype=torch.int64,
                        device=device).reshape(-1, 2)


def random_bits(k, n: int, device=None) -> torch.Tensor:
    """``jax.random.bits(k, (n,), uint32)`` under the partitionable
    threefry (JAX's default): [n] int64 words in [0, 2^32). ``k`` a
    ``[K, 2]`` key tensor: [K, n], row k under key k; a ``[2]`` key tensor:
    [n], the same words as the host key (``device`` is then the keys'
    own)."""
    if isinstance(k, torch.Tensor) and k.dim() == 1:
        # one key's [2] words on the device: a captured round reads its key
        # from a device table, where host ints would be frozen at capture
        k0, k1, device = k[0], k[1], k.device
    elif isinstance(k, torch.Tensor):
        k0, k1, device = k[:, 0:1], k[:, 1:2], k.device
    else:
        k0, k1 = k
    i = torch.arange(n, dtype=torch.int64, device=device)
    x0, x1 = threefry2x32(k0, k1, i >> 32, i & _MASK)
    return x0 ^ x1


def uniform(k, n: int, device=None) -> torch.Tensor:
    """``jax.random.uniform(k, (n,))``: [n] (or [K, n]) float32 in [0, 1)."""
    bits = ((random_bits(k, n, device) >> 9) | 0x3F800000).to(torch.int32)
    return bits.view(torch.float32) - 1.0


def exponential(k, n: int, device=None) -> torch.Tensor:
    """``jax.random.exponential(k, (n,))``: [n] (or [K, n]) float32, mean 1."""
    return -torch.log1p(-uniform(k, n, device))
