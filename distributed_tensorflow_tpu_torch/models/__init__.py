"""Models of the port: so far the causal pre-LN decoder's serve subset."""
