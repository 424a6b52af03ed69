"""Regenerate the rotavirus fixtures from ``rotavirus.bwa.img``.

``rotavirus.bwa.img`` is a ``bwa_idx2mem`` blob holding, field for field,
the index that stock ``bwa index`` built for the rotavirus reference.  This
script unpacks it with raw struct reads into the files ``bwa index`` writes
(``ref.fa.{bwt,sa,pac,ann,amb}``) and the FASTA they came from
(``ref.fa``, 70-column lines).  It uses none of the package's own index
code, so the byte-parity tests in ``test_index_build.py`` stay an
independent check of the builder and of ``index/bwtfile.py``.

    python tests/fixtures/extract_rotavirus.py
"""
import os
import struct

HERE = os.path.dirname(os.path.abspath(__file__))


def main(img=os.path.join(HERE, "rotavirus.bwa.img"), out=HERE):
    buf = open(img, "rb").read()
    # bwt_t (1120 bytes): primary, L2[5], seq_len, bwt_size, bwt*,
    # cnt_table[256], sa_intv (int32 at 1096), n_sa (at 1104)
    primary = struct.unpack_from("<Q", buf, 0)[0]
    L2 = struct.unpack_from("<5Q", buf, 8)
    seq_len, bwt_size = struct.unpack_from("<2Q", buf, 48)
    sa_intv = struct.unpack_from("<i", buf, 1096)[0]
    n_sa = struct.unpack_from("<Q", buf, 1104)[0]
    k = 1120
    words = buf[k : k + 4 * bwt_size]
    k += 4 * bwt_size
    sa = buf[k : k + 8 * n_sa]  # sa[0] is the (bwtint_t)-1 sentinel
    k += 8 * n_sa
    # bntseq_t (48 bytes): l_pac, n_seqs, seed, anns*, n_holes, ambs*, fp
    l_pac = struct.unpack_from("<q", buf, k)[0]
    n_seqs, seed = struct.unpack_from("<iI", buf, k + 8)
    n_holes = struct.unpack_from("<i", buf, k + 24)[0]
    k += 48
    ambs = []
    for _ in range(n_holes):  # bntamb1_t: offset i64, len i32, amb char
        off, ln = struct.unpack_from("<qi", buf, k)
        ambs.append((off, ln, chr(buf[k + 12])))
        k += 16
    anns = []
    for _ in range(n_seqs):  # bntann1_t: offset, len, n_ambs, gi, is_alt
        anns.append(struct.unpack_from("<qiiIi", buf, k))
        k += 40
    names = []
    for _ in range(n_seqs):
        name_end = buf.index(b"\x00", k)
        anno_end = buf.index(b"\x00", name_end + 1)
        names.append((buf[k:name_end].decode(),
                      buf[name_end + 1 : anno_end].decode()))
        k = anno_end + 1
    pac = buf[k : k + (l_pac >> 2) + (1 if l_pac & 3 else 0)]
    assert L2[4] == seq_len == 2 * l_pac

    p = os.path.join(out, "ref.fa")
    head = struct.pack("<5Q", primary, *L2[1:])
    with open(p + ".bwt", "wb") as fh:
        fh.write(head + words)
    with open(p + ".sa", "wb") as fh:
        fh.write(head + struct.pack("<2Q", sa_intv, seq_len) + sa[8:])
    with open(p + ".pac", "wb") as fh:
        fh.write(pac)
        if l_pac % 4 == 0:
            fh.write(b"\x00")
        fh.write(bytes([l_pac % 4]))
    with open(p + ".ann", "w") as fh:
        fh.write(f"{l_pac} {n_seqs} {seed}\n")
        for (off, ln, n_ambs, gi, _alt), (name, anno) in zip(anns, names):
            fh.write(f"{gi} {name} {anno}\n{off} {ln} {n_ambs}\n")
    with open(p + ".amb", "w") as fh:
        fh.write(f"{l_pac} {n_seqs} {n_holes}\n")
        for off, ln, amb in ambs:
            fh.write(f"{off} {ln} {amb}\n")
    # the forward strand, 2 bits per base, first base in the high bits
    bases = "".join(
        "ACGT"[(pac[i >> 2] >> ((~i & 3) << 1)) & 3] for i in range(l_pac)
    )
    for off, ln, amb in ambs:
        bases = bases[:off] + amb * ln + bases[off + ln :]
    with open(p, "w") as fh:
        for (off, ln, _n, _gi, _alt), (name, anno) in zip(anns, names):
            fh.write(f">{name}\n")
            seq = bases[off : off + ln]
            for i in range(0, ln, 70):
                fh.write(seq[i : i + 70] + "\n")


if __name__ == "__main__":
    main()
