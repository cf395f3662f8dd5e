"""TATP table ids and the CALL_FORWARDING composite key (the dense engine's
part of `dint_tpu.engines.tatp`)."""

SUBSCRIBER = 0
SEC_SUBSCRIBER = 1
ACCESS_INFO = 2
SPECIAL_FACILITY = 3
CALL_FORWARDING = 4


def cf_key(s_id, sf_type, start_time):
    """Composite CALL_FORWARDING key (start_time in {0, 8, 16}); works on
    ints, numpy arrays and tensors alike."""
    return s_id * 12 + (sf_type - 1) * 3 + start_time // 8
