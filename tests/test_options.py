"""Options ABI golden tests.

The analog of the reference's testOptsSize ABI-drift tripwire
(BwaMemIndexTest.java:38-43): the packed struct must stay exactly 168 bytes
with every field at its documented offset (SURVEY.md section 2.4,
BwaMemAligner.java:46-138).
"""
import struct

from bwamem_tpu.api.options import (
    MEM_F_PE,
    MEM_F_SOFTCLIP,
    OPTS_SIZE,
    MemOptions,
    fill_scoring_matrix,
)


def test_opts_size():
    assert len(MemOptions().pack()) == OPTS_SIZE == 168


def test_field_offsets_against_java_accessors():
    """Poke each documented Java accessor offset and check the right field moves."""
    offsets = {
        0: "a", 4: "b", 8: "o_del", 12: "e_del", 16: "o_ins", 20: "e_ins",
        24: "pen_unpaired", 28: "pen_clip5", 32: "pen_clip3", 36: "w",
        40: "zdrop", 56: "T", 60: "flag", 64: "min_seed_len",
        68: "min_chain_weight", 72: "max_chain_extend", 80: "split_width",
        84: "max_occ", 88: "max_chain_gap", 92: "n_threads", 96: "chunk_size",
        120: "mapq_coef_fac", 124: "max_ins", 128: "max_matesw",
        132: "max_xa_hits", 136: "max_xa_hits_alt",
    }
    base = MemOptions().pack()
    for off, name in offsets.items():
        val = struct.unpack_from("<i", base, off)[0]
        assert val == getattr(MemOptions(), name), (off, name)
    assert struct.unpack_from("<q", base, 48)[0] == MemOptions().max_mem_intv
    for off, name in {
        76: "split_factor", 100: "mask_level", 104: "drop_ratio",
        108: "xa_drop_ratio", 112: "mask_level_redun", 116: "mapq_coef_len",
    }.items():
        val = struct.unpack_from("<f", base, off)[0]
        assert abs(val - getattr(MemOptions(), name)) < 1e-6, (off, name)
    mat = struct.unpack_from("<25b", base, 140)
    assert list(mat) == fill_scoring_matrix(1, 4)


def test_defaults_match_mem_opt_init():
    o = MemOptions()
    assert (o.a, o.b) == (1, 4)
    assert (o.o_del, o.e_del, o.o_ins, o.e_ins) == (6, 1, 6, 1)
    assert (o.w, o.T, o.zdrop) == (100, 30, 100)
    assert (o.pen_unpaired, o.pen_clip5, o.pen_clip3) == (17, 5, 5)
    assert (o.min_seed_len, o.split_width, o.max_occ) == (19, 10, 500)
    assert o.max_mem_intv == 20
    assert (o.max_chain_gap, o.max_ins) == (10000, 10000)
    assert (o.mask_level, o.drop_ratio, o.xa_drop_ratio) == (0.50, 0.50, 0.80)
    assert o.split_factor == 1.5
    assert (o.chunk_size, o.n_threads) == (10000000, 1)
    assert (o.max_xa_hits, o.max_xa_hits_alt, o.max_matesw) == (5, 200, 50)
    assert o.mask_level_redun == 0.95
    assert (o.mapq_coef_len, o.mapq_coef_fac) == (50.0, 3)
    assert o.split_len == 28  # int(19 * 1.5 + .499)


def test_pack_unpack_roundtrip():
    o = MemOptions(a=2, b=9, w=50, flag=MEM_F_PE | MEM_F_SOFTCLIP)
    o.refresh_matrix()
    # float fields round to f32 in the ABI; bytes must be stable through a
    # full unpack/pack cycle
    raw = o.pack()
    assert MemOptions.unpack(raw).pack() == raw
    assert MemOptions.unpack(raw).flag == o.flag
    assert MemOptions.unpack(raw).mat == o.mat


def test_intra_ctg_preset():
    o = MemOptions().set_intra_ctg()
    assert (o.o_del, o.o_ins, o.b, o.pen_clip5, o.pen_clip3) == (16, 16, 9, 5, 5)
    assert o.mat[1] == -9
