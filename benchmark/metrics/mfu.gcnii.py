"""Model operations of a GCNII epoch (``benchlib.gcnii_counts.epoch_flops``:
the input and output Linears and each layer's SpMM, mixes and product,
forward and backward) over ``epoch_ms`` of the untraced window times the
published dense bf16 peak. Moves ``epoch_ms``."""

from benchlib import peaks


def read(view):
    flops = view.counters.get("model_flops_per_unit")
    epoch_ms = view.e2e.get("epoch_ms")
    if not flops or not epoch_ms:
        return None
    return 100.0 * flops / (epoch_ms / 1e3 * peaks.BF16_FLOPS)
