"""Entry points of the port (mirrors of `banjax_tpu/cli.py` build_matcher
and of the chain assembly in `banjax_tpu/httpapi/server.py`)."""

from __future__ import annotations

from banjax_tpu_torch.device import DeviceLike


def build_matcher(config, banner, static_lists, device: DeviceLike = None):
    """The Matcher seam flag: `matcher: tpu` selects the device matcher,
    which the port runs on the card (or on the CPU when `device="cpu"`).
    The host reference matcher (`matcher: cpu`) stays in the JAX package."""
    if config.matcher != "tpu":
        raise ValueError(
            f"matcher: {config.matcher} is the host reference matcher; the "
            "port runs matcher: tpu"
        )
    from banjax_tpu_torch.matcher.runner import TorchMatcher

    return TorchMatcher(config, banner, static_lists, device=device)


def build_decision_chain(config, banner, static_lists, device: DeviceLike = None):
    """The `/auth_request` decision chain's state: the Banner's dynamic
    lists (so a TorchMatcher built on the same Banner feeds chain step 7),
    the password-protected paths, the failed-challenge state and the PoW
    verifier, which runs kernel C on the card (or its plain version when
    `device="cpu"`). `config` must carry the pages (`config.load_pages`).
    Raises without a GPU unless `device="cpu"` is passed."""
    from banjax_tpu_torch.challenge.failures import make_failed_challenge_states
    from banjax_tpu_torch.challenge.verifier import from_config
    from banjax_tpu_torch.decisions.protected_paths import PasswordProtectedPaths
    from banjax_tpu_torch.device import resolve_device
    from banjax_tpu_torch.httpapi.decision_chain import ChainState

    dev = resolve_device(device)
    return ChainState(
        config=config,
        static_lists=static_lists,
        dynamic_lists=banner.decision_lists,
        protected_paths=PasswordProtectedPaths(config),
        failed_challenge_states=make_failed_challenge_states(config),
        banner=banner,
        challenge_verifier=from_config(config, dev),
    )
