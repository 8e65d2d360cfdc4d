"""The port's own kernels, one file each, found by the key that a member's
``kernels`` entry names: ``NAMES`` (parts of the kernel's names on the card)
and, for a kernel whose roofline is read, ``work_bytes(args, kwargs,
**params)``, the bytes that one update's work needs (``harness/roofline.py``
gives the counting rule)."""
