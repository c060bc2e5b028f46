"""Feature-id hashing: CityHash64 and the field-packed key.

The reference hashes Criteo/adfea categorical features with CityHash64 and
packs the field/group id into the top 10 bits:
``(CityHash64(s) >> 10) | (field << 54)`` (reference
learn/base/criteo_parser.h:69-82, adfea_parser.h:56-64), reimplemented
here from the public CityHash v1.1 algorithm. The port's copy of the JAX
package's module, less the byte-reversal key spreading that no module of
the port calls: ``cityhash64`` is the contract of the card's hash
(csrc/formats.cu ``cityhash64``), which the criteo parse kernel runs on
every field.
"""

from __future__ import annotations

import struct

_M = (1 << 64) - 1  # u64 mask

K0 = 0xC3A5C85C97CB3127
K1 = 0xB492B66FBE98F273
K2 = 0x9AE16A3B2F90404F
_KMUL = 0x9DDFEA08EB382D69


def _rotr(v: int, s: int) -> int:
    return ((v >> s) | (v << (64 - s))) & _M if s else v


def _shift_mix(v: int) -> int:
    return (v ^ (v >> 47)) & _M


def _f64(s: bytes, i: int) -> int:
    return struct.unpack_from("<Q", s, i)[0]


def _f32(s: bytes, i: int) -> int:
    return struct.unpack_from("<I", s, i)[0]


def _hash128to64(u: int, v: int) -> int:
    a = ((u ^ v) * _KMUL) & _M
    a ^= a >> 47
    b = ((v ^ a) * _KMUL) & _M
    b ^= b >> 47
    return (b * _KMUL) & _M


def _hashlen16_mul(u: int, v: int, mul: int) -> int:
    a = ((u ^ v) * mul) & _M
    a ^= a >> 47
    b = ((v ^ a) * mul) & _M
    b ^= b >> 47
    return (b * mul) & _M


def _hashlen0to16(s: bytes) -> int:
    n = len(s)
    if n >= 8:
        mul = (K2 + n * 2) & _M
        a = (_f64(s, 0) + K2) & _M
        b = _f64(s, n - 8)
        c = (_rotr(b, 37) * mul + a) & _M
        d = ((_rotr(a, 25) + b) * mul) & _M
        return _hashlen16_mul(c, d, mul)
    if n >= 4:
        mul = (K2 + n * 2) & _M
        a = _f32(s, 0)
        return _hashlen16_mul((n + (a << 3)) & _M, _f32(s, n - 4), mul)
    if n > 0:
        a, b, c = s[0], s[n >> 1], s[n - 1]
        y = (a + (b << 8)) & _M
        z = (n + (c << 2)) & _M
        return (_shift_mix((y * K2) & _M ^ (z * K0) & _M) * K2) & _M
    return K2


def _hashlen17to32(s: bytes) -> int:
    n = len(s)
    mul = (K2 + n * 2) & _M
    a = (_f64(s, 0) * K1) & _M
    b = _f64(s, 8)
    c = (_f64(s, n - 8) * mul) & _M
    d = (_f64(s, n - 16) * K2) & _M
    return _hashlen16_mul(
        (_rotr((a + b) & _M, 43) + _rotr(c, 30) + d) & _M,
        (a + _rotr((b + K2) & _M, 18) + c) & _M,
        mul,
    )


def _hashlen33to64(s: bytes) -> int:
    n = len(s)
    mul = (K2 + n * 2) & _M
    a = (_f64(s, 0) * K2) & _M
    b = _f64(s, 8)
    c = _f64(s, n - 24)
    d = _f64(s, n - 32)
    e = (_f64(s, 16) * K2) & _M
    f = (_f64(s, 24) * 9) & _M
    g = _f64(s, n - 8)
    h = (_f64(s, n - 16) * mul) & _M
    u = (_rotr((a + g) & _M, 43) + ((_rotr(b, 30) + c) & _M) * 9) & _M
    v = (((a + g) & _M ^ d) + f + 1) & _M
    w = (int.from_bytes((((u + v) * mul) & _M).to_bytes(8, "little"), "big") + h) & _M
    x = (_rotr((e + f) & _M, 42) + c) & _M
    y = (
        (int.from_bytes((((v + w) * mul) & _M).to_bytes(8, "little"), "big") + g) * mul
    ) & _M
    z = (e + f + c) & _M
    a = (
        int.from_bytes(
            ((((x + z) & _M) * mul + y) & _M).to_bytes(8, "little"), "big"
        )
        + b
    ) & _M
    b = (_shift_mix((((z + a) & _M) * mul + d + h) & _M) * mul) & _M
    return (b + x) & _M


def _weak32(w: int, x: int, y: int, z: int, a: int, b: int):
    a = (a + w) & _M
    b = _rotr((b + a + z) & _M, 21)
    c = a
    a = (a + x + y) & _M
    b = (b + _rotr(a, 44)) & _M
    return (a + z) & _M, (b + c) & _M


def _weak32_at(s: bytes, i: int, a: int, b: int):
    return _weak32(_f64(s, i), _f64(s, i + 8), _f64(s, i + 16), _f64(s, i + 24), a, b)


def cityhash64(data) -> int:
    """CityHash64 (v1.1) of bytes/str, as a Python int in [0, 2^64)."""
    s = data.encode() if isinstance(data, str) else bytes(data)
    n = len(s)
    if n <= 16:
        return _hashlen0to16(s)
    if n <= 32:
        return _hashlen17to32(s)
    if n <= 64:
        return _hashlen33to64(s)
    x = _f64(s, n - 40)
    y = (_f64(s, n - 16) + _f64(s, n - 56)) & _M
    z = _hash128to64((_f64(s, n - 48) + n) & _M, _f64(s, n - 24))
    v = _weak32_at(s, n - 64, n & _M, z)
    w = _weak32_at(s, n - 32, (y + K1) & _M, x)
    x = (x * K1 + _f64(s, 0)) & _M
    pos = 0
    rem = (n - 1) & ~63
    while True:
        x = (_rotr((x + y + v[0] + _f64(s, pos + 8)) & _M, 37) * K1) & _M
        y = (_rotr((y + v[1] + _f64(s, pos + 48)) & _M, 42) * K1) & _M
        x ^= w[1]
        y = (y + v[0] + _f64(s, pos + 40)) & _M
        z = (_rotr((z + w[0]) & _M, 33) * K1) & _M
        v = _weak32_at(s, pos, (v[1] * K1) & _M, (x + w[0]) & _M)
        w = _weak32_at(s, pos + 32, (z + w[1]) & _M, (y + _f64(s, pos + 16)) & _M)
        z, x = x, z
        pos += 64
        rem -= 64
        if rem == 0:
            break
    return _hash128to64(
        (_hash128to64(v[0], w[0]) + ((_shift_mix(y) * K1) & _M) + z) & _M,
        (_hash128to64(v[1], w[1]) + x) & _M,
    )


def pack_field_key(s, field: int) -> int:
    """``(CityHash64(s) >> 10) | (field << 54)`` — the reference's key layout
    (criteo_parser.h:69-70): hash in the low 54 bits, field id in the top 10.
    """
    return ((cityhash64(s) >> 10) | ((field & 0x3FF) << 54)) & _M

