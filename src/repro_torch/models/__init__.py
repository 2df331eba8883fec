"""The language-model stack of every family (counterpart of
:mod:`repro.models`): config, layers, attention (K8 on the card), the
MoE dispatch, the Mamba2/SSD scan, the blocks and each family's
prefill/decode."""
