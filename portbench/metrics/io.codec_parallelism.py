"""io.codec_parallelism: the codec's thread-seconds of formatting per
second of ``final_state.dat``: the sum of the ``format_ns`` counts of the
read solves' ``lbm.io.final_state`` spans over the sum of their lengths.
At most the codec's thread count; at most 1 where the file is one block.
Nothing without a recording."""

from portbench import spans


def read(run):
    _, found = spans.read_spans(run, "lbm.io.final_state")
    length = sum(s.end_ns - s.start_ns for s in found)
    if length <= 0:
        return None
    return sum(s.attrs.get("format_ns", 0) for s in found) / length
