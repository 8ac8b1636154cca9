"""The benchmark of `eetq_tpu_torch`: the port's engine served over HTTP."""
