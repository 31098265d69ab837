"""Password-protected path classification.

Reference behavior (Go banjax): internal/password_protected_path.go —
an immutable snapshot of site→protected-path-prefixes, site→exceptions
(exact-path match), site→password-hash (hex-decoded sha256), roaming hashes
(a subdomain inherits its root site's hash, which flips the root's
expand-cookie-domain flag), and the ClassifyPath rule: an exact exception
beats a prefix-protected path.
"""

from __future__ import annotations

import enum
from typing import Dict, Optional, Tuple

from banjax_tpu_torch.config import Config


class PathType(enum.IntEnum):
    NOT_PASSWORD_PROTECTED = 0
    PASSWORD_PROTECTED = 1
    PASSWORD_PROTECTED_EXCEPTION = 2


def _normalize(path: str) -> str:
    # password_protected_path.go:134 — "/" + strings.Trim(path, "/")
    return "/" + path.strip("/")


class _Snapshot:
    __slots__ = (
        "site_to_protected_paths",
        "site_to_exceptions",
        "site_to_password_hash",
        "site_to_roaming_password_hash",
        "site_to_expand_cookie_domain",
    )

    def __init__(self, config: Config):
        self.site_to_protected_paths: Dict[str, Dict[str, bool]] = {}
        self.site_to_exceptions: Dict[str, Dict[str, bool]] = {}
        self.site_to_password_hash: Dict[str, bytes] = {}
        self.site_to_roaming_password_hash: Dict[str, bytes] = {}
        self.site_to_expand_cookie_domain: Dict[str, bool] = {}

        for site, paths in config.password_protected_paths.items():
            for path in paths or []:
                self.site_to_protected_paths.setdefault(site, {})[_normalize(path)] = True

        for site, exceptions in config.password_protected_path_exceptions.items():
            for exc in exceptions or []:
                self.site_to_exceptions.setdefault(site, {})[_normalize(exc)] = True

        for site, hash_hex in config.password_hashes.items():
            try:
                self.site_to_password_hash[site] = bytes.fromhex(hash_hex)
            except ValueError:
                raise ValueError(f"bad password hash: {hash_hex!r}") from None

        for site, root_site in config.password_hash_roaming.items():
            # password_protected_path.go:169-177 — only if the root has a hash
            root_hash = self.site_to_password_hash.get(root_site)
            if root_hash is not None:
                self.site_to_roaming_password_hash[site] = root_hash
                self.site_to_expand_cookie_domain[root_site] = True


class PasswordProtectedPaths:
    def __init__(self, config: Config):
        self._snapshot = _Snapshot(config)

    def update_from_config(self, config: Config) -> None:
        self._snapshot = _Snapshot(config)

    def get_password_hash(self, site: str) -> Tuple[Optional[bytes], bool]:
        v = self._snapshot.site_to_password_hash.get(site)
        return v, v is not None

    def get_roaming_password_hash(self, site: str) -> Tuple[Optional[bytes], bool]:
        v = self._snapshot.site_to_roaming_password_hash.get(site)
        return v, v is not None

    def get_expand_cookie_domain(self, site: str) -> Tuple[bool, bool]:
        c = self._snapshot.site_to_expand_cookie_domain
        return c.get(site, False), site in c

    def is_exception(self, site: str, path: str) -> bool:
        """Exact match against the exception set (password_protected_path.go:61-70)."""
        exceptions = self._snapshot.site_to_exceptions.get(site)
        return bool(exceptions and exceptions.get(path))

    def classify_path(self, site: str, path: str) -> PathType:
        """password_protected_path.go:72-90 — exception (exact) beats protected (prefix)."""
        c = self._snapshot
        path_map = c.site_to_protected_paths.get(site)
        if path_map is not None:
            exceptions = c.site_to_exceptions.get(site)
            if not exceptions or not exceptions.get(path):
                for protected_path, flag in path_map.items():
                    if flag and path.startswith(protected_path):
                        return PathType.PASSWORD_PROTECTED
            else:
                return PathType.PASSWORD_PROTECTED_EXCEPTION
        return PathType.NOT_PASSWORD_PROTECTED
