"""yak_tpu_torch: the k-mer spectrum engine on PyTorch and CUDA.

A port of `yak_tpu` (JAX on a TPU) to PyTorch, with the merge-reduce
kernel of the count path written by hand in CUDA C++ for Hopper
(`csrc/merge_reduce.cu`).  The JAX package stays the reference; this
package imports torch and numpy and never jax, directly or through
`yak_tpu` (whose `__init__` imports jax), so the host code it needs is
ported here rather than imported.

Keys travel as int64: a k <= 31 canonical hash is below 2^62, so signed
order is unsigned order and the invalid/INF sentinel is INT64_MAX
(`ops/keys.py`).  Every table and step names its device; a CUDA tensor
goes through the hand-written kernel, a CPU tensor through its plain
torch version.
"""

__version__ = "0.1.0"

YAK_MAX_KMER = 31        # yak.h:8
YAK_COUNTER_BITS = 10    # yak.h:9
YAK_N_COUNTS = 1 << YAK_COUNTER_BITS
YAK_MAX_COUNT = (1 << YAK_COUNTER_BITS) - 1
YAK_BLK_SHIFT = 9        # yak.h:13 (512-bit Bloom blocks)
YAK_MAGIC = b"YAK\2"     # yak.h:23

# Table load modes (yak.h:16-21)
YAK_LOAD_ALL = 1
YAK_LOAD_TRIOBIN1 = 2
YAK_LOAD_TRIOBIN2 = 3
YAK_LOAD_SEXCHR1 = 4
YAK_LOAD_SEXCHR2 = 5
YAK_LOAD_SEXCHR3 = 6
