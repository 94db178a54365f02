"""setup.libraries_s: seconds of the warm solve's outermost
``lbm.ops.library``, ``lbm.io.codec_library`` and ``lbm.ops.prepare``
spans: the kernel library and the codec built or loaded, and the
kernels prepared, in set-up.  Nothing without a recording or such a
span."""

from portbench import spans

LIBRARIES = ("lbm.ops.library", "lbm.io.codec_library", "lbm.ops.prepare")


def read(run):
    found = spans.warm_outermost(run, LIBRARIES)
    return sum(s.seconds for s in found) if found else None
