"""FLOPs of a PPO update of an MLP actor-critic, from its widths alone.

A dense layer of ``n_in`` to ``n_out`` costs ``2 n_in n_out`` FLOPs a row
forward plus ``n_out`` for its bias, and twice the product backward (the
gradients of its input and of its weights) plus ``n_out``.  A first layer
over a discrete observation is the gather it is: ``n_out`` adds forward,
``n_out`` backward, no product.  The collect runs two forwards a row (the
acted-on observation and the pre-reset successor's value); the learn half
runs a forward and a backward a row in each epoch.  ``tanh``, softmax and
the optimizer are not counted.
"""


def update_flops(n_in: int, hidden, n_act: int, discrete: bool, rows: int,
                 epochs: int) -> float:
    widths = [n_in, *hidden]
    fwd = bwd = 0
    for i, (a, b) in enumerate(zip(widths, widths[1:])):
        if i == 0 and discrete:
            fwd, bwd = fwd + b, bwd + b
        else:
            fwd, bwd = fwd + 2 * a * b + b, bwd + 4 * a * b + b
    heads = n_act + 1
    fwd += 2 * widths[-1] * heads + heads
    bwd += 4 * widths[-1] * heads + heads
    return float(rows) * (2 * fwd + epochs * (fwd + bwd))
