"""QuickLZ level-1 decompressor (pure Python; a copy of
ppg_slam_tpu/bow/quicklz.py).

DBoW3 stores binary vocabularies as a sequence of QuickLZ-compressed chunks
(Vocabulary::toStream with compressed=true). This implements the level-1,
non-streaming decode path of quicklz 1.5.x — enough to read the shipped
voc_euroc_9x3.gz / voc_tum_9x3.gz files (reference Vocabulary/).
"""

from __future__ import annotations

# literals consumable per step = trailing zeros of the control word (0 -> 4);
# odd indices are unreachable (bit0 == 0 in the literal branch)
_BITLUT = [4, 0, 1, 0, 2, 0, 1, 0, 3, 0, 1, 0, 2, 0, 1, 0]

UNCONDITIONAL_MATCHLEN = 6
UNCOMPRESSED_END = 4
CWORD_LEN = 4


def size_header(src: bytes) -> int:
    return 9 if (src[0] & 2) else 3


def size_compressed(src: bytes) -> int:
    if src[0] & 2:
        return int.from_bytes(src[1:5], "little")
    return src[1]


def size_decompressed(src: bytes) -> int:
    if src[0] & 2:
        return int.from_bytes(src[5:9], "little")
    return src[2]


def decompress(src: bytes) -> bytes:
    """Decompress one quicklz level-1 block."""
    flags = src[0]
    hdr = size_header(src)
    dsize = size_decompressed(src)
    if not (flags & 1):  # stored uncompressed
        return bytes(src[hdr:hdr + dsize])
    level = (flags >> 2) & 0x3
    if level != 1:
        raise NotImplementedError(f"quicklz level {level} not supported")

    s = hdr
    dst = bytearray(dsize)
    d = 0
    cword = 1
    hashtable = [0] * 4096
    last_hashed = -1  # index of last dst position hashed
    last_matchstart = dsize - 1 - UNCONDITIONAL_MATCHLEN - UNCOMPRESSED_END

    def update_hash_upto(max_idx: int) -> None:
        # C semantics: update positions <= max_idx (update_hash_upto in
        # quicklz.c walks the pointer up to and including `max`)
        nonlocal last_hashed
        while last_hashed < max_idx:
            last_hashed += 1
            x = (dst[last_hashed] | (dst[last_hashed + 1] << 8)
                 | (dst[last_hashed + 2] << 16))
            hashtable[((x >> 12) ^ x) & 0xFFF] = last_hashed

    while True:
        if cword == 1:
            cword = int.from_bytes(src[s:s + CWORD_LEN], "little")
            s += CWORD_LEN
        if cword & 1:
            cword >>= 1
            fetch = int.from_bytes(src[s:s + 4], "little")
            h = (fetch >> 4) & 0xFFF
            offset2 = hashtable[h]
            if fetch & 0xF:
                matchlen = (fetch & 0xF) + 2
                s += 2
            else:
                matchlen = src[s + 2]
                s += 3
            # overlapping copy
            for k in range(matchlen):
                dst[d + k] = dst[offset2 + k]
            d += matchlen
            update_hash_upto(d - matchlen)  # up to the match start
            last_hashed = d - 1
        else:
            if d < last_matchstart:
                n = _BITLUT[cword & 0xF]
                dst[d:d + n] = src[s:s + n]
                cword >>= n
                d += n
                s += n
                update_hash_upto(d - 3)
            else:
                while d <= dsize - 1:
                    if cword == 1:
                        s += CWORD_LEN
                        cword = 0x80000000
                    dst[d] = src[s]
                    d += 1
                    s += 1
                    cword >>= 1
                return bytes(dst)
