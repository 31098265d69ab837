"""Small Go-stdlib-compatible helpers."""

from banjax_tpu_torch.utils.goquery import go_query_escape, go_query_unescape

__all__ = ["go_query_escape", "go_query_unescape"]
