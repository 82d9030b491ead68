"""LM serving: the decode cache's lifecycle and the batched server."""
