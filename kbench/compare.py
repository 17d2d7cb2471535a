"""The comparisons that decide `correct`: the program's outputs against
the reference's, each as a number with its limit.  Every comparison
here is exact, so every limit is 0."""

import torch

from kbench.reference import kmers


def table_digest(keys, counts):
    """A 64-bit digest of a table's (key, count) pairs, in key order,
    taken on the table's device: (number of pairs, wrapping sum of the
    mixed pairs)."""
    k = keys.to(torch.int64)
    c = counts.to(torch.int64)
    mixed = (k * -7046029254386353131) ^ (c * 0x2545F4914F6CDD1D + k)
    return int(k.numel()), int(mixed.sum())


def judge_table(keys, counts, hist, ref_keys, ref_counts):
    """How far the program's table (keys, counts) and its histogram lie
    from the reference's table (ascending, unique): the difference of
    their sizes, the reference keys it lacks, the keys it holds that the
    reference does not, the shared keys whose counts differ, and the
    histogram's bins that differ."""
    keys, counts = keys.to(torch.int64), counts.to(torch.int64)
    ref_counts = ref_counts.to(torch.int64)
    missing = int((~torch.isin(ref_keys, keys)).sum())
    extra = int((~torch.isin(keys, ref_keys)).sum())
    if ref_keys.numel():
        pos = torch.searchsorted(ref_keys, keys).clamp(
            max=ref_keys.numel() - 1)
        wrong = int(((ref_keys[pos] == keys)
                     & (ref_counts[pos] != counts)).sum())
    else:
        wrong = 0
    ref_hist = kmers.hist(ref_counts).cpu()
    return {"size_diff": abs(keys.numel() - ref_keys.numel()),
            "keys_missing": missing, "keys_extra": extra,
            "counts_wrong": wrong,
            "hist_wrong": int((torch.as_tensor(hist) != ref_hist).sum())}


def lines_wrong(text, ref_text):
    """Lines of `text` that differ from the reference's, position by
    position, and the lines one has beyond the other."""
    a, b = text.split("\n"), ref_text.split("\n")
    return sum(x != y for x, y in zip(a, b)) + abs(len(a) - len(b))

