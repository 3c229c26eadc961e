from .reviser_kernel import stack_logits_reference, stack_logits_single

__all__ = ["stack_logits_single", "stack_logits_reference"]
