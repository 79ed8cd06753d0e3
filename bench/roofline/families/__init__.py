"""Each model family's model-FLOP counts, one module per family, found by the
``"family"`` of a configuration's model block (:func:`bench.family.find`).

A family module takes the model block ``m`` (a plain dict) and gives:

* ``matmul_params(m)``: the weights each token is multiplied by, summed over
  all layers (no norm, bias, conv or head; a mixture of experts counts its
  router and ``top_k`` experts, not all of them);
* ``attention_flops(m, batch, seq)``: the forward operations of every
  layer's causal self-attention over ``batch`` rows of ``seq`` tokens, 4 * D
  per visible (query, key) pair and query head, 0 where there is none;
* ``scan_layers(m)``: the Mamba-1 selective scans one forward runs.

A family whose layers differ counts each layer by its kind.
"""
