"""The LM stack's models: dense transformers and Mamba2 SSMs, as
`nn.Module`s holding their parameters, with the layer functions as
plain functions on tensors."""
