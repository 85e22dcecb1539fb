"""Error taxonomy mirroring the reference's python/exceptions.py.

The parse loop catches ADSBError per message and drops the message
(fault tolerance = skip-and-continue; SURVEY.md §2.3 / §5.3).

A copy of `airmodes.exceptions`: the port imports nothing of the JAX
package.
"""


class ADSBError(Exception):
    """Base class for all decode-chain errors."""


class MetricAltError(ADSBError):
    """Altitude field uses metric encoding (M bit set) — unsupported."""


class ParserError(ADSBError):
    """Frame failed re-validation or field extraction during parse."""


class NoHandlerError(ADSBError):
    """No handler registered for this downlink format / type code."""

    def __init__(self, msgtype=None):
        self.msgtype = msgtype
        super().__init__(f"no handler for message type {msgtype}")


class MlatNonConvergeError(ADSBError):
    """Multilateration Gauss-Newton solver failed to converge."""


class CPRNoPositionError(ADSBError):
    """Not enough CPR frames cached to resolve a position."""


class CPRBoundaryStraddleError(CPRNoPositionError):
    """Even/odd CPR pair straddles an NL zone boundary; global decode invalid."""


class FieldNotInPacket(ParserError):
    """Requested bitfield does not exist in this packet layout."""

    def __init__(self, field=None):
        self.field = field
        super().__init__(f"field {field} not in packet")
