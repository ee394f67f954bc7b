"""The whole update's share of the card's peak: the update's model FLOPs
(``floors/``, from the network's widths and the traffic's shapes) over
the window's seconds an update (all its time over all its updates) times
the published peak of the compute dtype."""


def read(rec):
    win, fl, pk = rec["window"], rec["floor"], rec["peaks"]
    if not fl or not pk or not win["units"] or win["window_s"] <= 0:
        return None
    peak = pk[{"float32": "f32_flops", "bfloat16": "bf16_flops"}[fl["dtype"]]]
    return 100.0 * fl["flops"] / (win["window_s"] / win["units"]) / peak
