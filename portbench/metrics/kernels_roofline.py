"""kernels_roofline: the least time of the traced solves' work (``work.py``:
the deck's operations and bytes once per solve, at the card's published
peaks) over the union of kernel intervals in their Compute phases, in %.
Nothing without a trace, a kernel or a card in the table of peaks."""

from portbench import work


def read(run):
    t = run.trace
    peak = work.peaks(run.device_name)
    if not t or peak is None or t["kernel_s"] <= 0:
        return None
    deck = run.cell.deck
    least, _ = work.least_seconds(deck.obstacles, deck.max_iters, peak)
    return 100.0 * least * t["phases"] / t["kernel_s"]
