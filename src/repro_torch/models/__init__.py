"""The language-model stack, dense family (counterpart of
:mod:`repro.models`): config, layers, attention (K8 on the card), dense
blocks and the decoder's prefill/decode."""
