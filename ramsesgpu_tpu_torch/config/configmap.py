"""Typed INI configuration reader.

Drop-in equivalent of the reference's ``ConfigMap`` (src/utils/config/ConfigMap.h:21-40,
built on inih): reads the very same ``data/*.ini`` problem files, exposes typed
getters with defaults, and supports programmatic write-back (the reference uses
``setInteger`` to force ghostWidth for the relaxing-TVD scheme,
src/euler_main.cpp:113).

The port's own copy of ramsesgpu_tpu/config/configmap.py: the port imports nothing of
the JAX package.
"""
from __future__ import annotations

import configparser
import io
from pathlib import Path

_TRUE_STRINGS = {"1", "yes", "true", "on", "enable", "enabled"}
_FALSE_STRINGS = {"0", "no", "false", "off", "disable", "disabled", ""}


class ConfigMap:
    """Case-insensitive section/key store over an INI file."""

    def __init__(self, filename: str | Path | None = None, text: str | None = None):
        self._parser = configparser.ConfigParser(
            inline_comment_prefixes=("#", ";"),
            comment_prefixes=("#", ";"),
            strict=False,
            interpolation=None,
        )
        # keep keys case-insensitive (configparser default lowers them; the
        # reference's inih is case-sensitive but all shipped .ini files are
        # consistent, so lowercase normalization is safe and more forgiving).
        if filename is not None:
            path = Path(filename)
            if not path.exists():
                raise FileNotFoundError(f"config file not found: {path}")
            self._parser.read(path)
        if text is not None:
            self._parser.read_string(text)

    # -- getters -----------------------------------------------------------
    def _raw(self, section: str, key: str) -> str | None:
        try:
            return self._parser.get(section, key)
        except (configparser.NoSectionError, configparser.NoOptionError):
            return None

    def get_string(self, section: str, key: str, default: str = "") -> str:
        value = self._raw(section, key)
        return default if value is None else value.strip()

    def get_float(self, section: str, key: str, default: float = 0.0) -> float:
        value = self._raw(section, key)
        if value is None or value.strip() == "":
            return default
        try:
            return float(value)
        except ValueError:
            return default

    def get_integer(self, section: str, key: str, default: int = 0) -> int:
        value = self._raw(section, key)
        if value is None or value.strip() == "":
            return default
        try:
            return int(value)
        except ValueError:
            # tolerate "1.0"-style ints (slope_type=1.0 in shipped configs)
            try:
                return int(float(value))
            except ValueError:
                return default

    def get_bool(self, section: str, key: str, default: bool = False) -> bool:
        value = self._raw(section, key)
        if value is None:
            return default
        v = value.strip().lower()
        if v in _TRUE_STRINGS:
            return True
        if v in _FALSE_STRINGS:
            return False
        return default

    # -- setters (programmatic override, cf. euler_main.cpp:113) ------------
    def _ensure_section(self, section: str) -> None:
        if not self._parser.has_section(section):
            self._parser.add_section(section)

    def set_string(self, section: str, key: str, value: str) -> None:
        self._ensure_section(section)
        self._parser.set(section, key, value)

    def set_integer(self, section: str, key: str, value: int) -> None:
        self.set_string(section, key, str(value))

    def set_float(self, section: str, key: str, value: float) -> None:
        self.set_string(section, key, repr(float(value)))

    def set_bool(self, section: str, key: str, value: bool) -> None:
        self.set_string(section, key, "yes" if value else "no")

    # -- utilities -----------------------------------------------------------
    def has(self, section: str, key: str) -> bool:
        return self._raw(section, key) is not None

    def sections(self) -> list[str]:
        return self._parser.sections()

    def items(self, section: str) -> dict[str, str]:
        if not self._parser.has_section(section):
            return {}
        return dict(self._parser.items(section))

    def dump(self) -> str:
        """Serialize back to INI text (``--dump-param-file`` support)."""
        buf = io.StringIO()
        self._parser.write(buf)
        return buf.getvalue()

    def write(self, filename: str | Path) -> None:
        Path(filename).write_text(self.dump())
