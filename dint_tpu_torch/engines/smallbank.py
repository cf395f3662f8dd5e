"""SmallBank table ids (the dense engine's part of
`dint_tpu.engines.smallbank`, smallbank/ebpf/smallbank.h:20-66)."""

SAVINGS = 0
CHECKING = 1
