"""Time per output token, 90th percentile over every window request (ms):
(last token event - first token event) / (tokens - 1), as the client
received them. A failed request counts as missing (`stats.latencies`)."""

from servebench.stats import percentile


def read(run):
    return percentile(run.latency["tpot"], 90) if run.latency["tpot"] else None
