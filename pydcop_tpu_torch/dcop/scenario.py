"""Dynamic-DCOP scenarios: timed event streams.

Equivalent capability to the reference's pydcop/dcop/scenario.py
(EventAction :37, DcopEvent :55, Scenario :95).  Events either wait
(``delay``) or perform actions (``add_agent``, ``remove_agent``, external
variable changes) against the running system.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional

from pydcop_tpu_torch.utils.serialization import SimpleRepr


class EventAction(SimpleRepr):
    """One action of a scenario event, e.g. remove_agent(agent='a1')."""

    def __init__(self, action_type: str, **parameters):
        self._action_type = action_type
        self._parameters = dict(parameters)

    @property
    def type(self) -> str:
        return self._action_type

    @property
    def parameters(self) -> Dict:
        return dict(self._parameters)

    def __repr__(self):
        return f"EventAction({self._action_type!r}, {self._parameters})"

    def _simple_repr(self):
        from pydcop_tpu_torch.utils.serialization import REPR_MODULE, REPR_QUALNAME
        return {REPR_MODULE: type(self).__module__,
                REPR_QUALNAME: type(self).__qualname__,
                "action_type": self._action_type,
                **self._parameters}

    @classmethod
    def _from_repr(cls, r):
        from pydcop_tpu_torch.utils.serialization import REPR_MODULE, REPR_QUALNAME
        kw = {k: v for k, v in r.items()
              if k not in (REPR_MODULE, REPR_QUALNAME, "action_type")}
        return cls(r["action_type"], **kw)


class DcopEvent(SimpleRepr):
    """A scenario event: either a delay or a list of actions."""

    def __init__(
        self,
        event_id: str,
        delay: Optional[float] = None,
        actions: Optional[List[EventAction]] = None,
    ):
        self._event_id = event_id
        self._delay = delay
        self._actions = list(actions) if actions else []

    @property
    def id(self) -> str:
        return self._event_id

    @property
    def is_delay(self) -> bool:
        return self._delay is not None

    @property
    def delay(self) -> Optional[float]:
        return self._delay

    @property
    def actions(self) -> List[EventAction]:
        return list(self._actions)

    def __repr__(self):
        if self.is_delay:
            return f"DcopEvent({self._event_id!r}, delay={self._delay})"
        return f"DcopEvent({self._event_id!r}, {self._actions})"


class Scenario(SimpleRepr):
    """An ordered stream of events applied to a running dynamic DCOP."""

    def __init__(self, events: Optional[Iterable[DcopEvent]] = None):
        self._events = list(events) if events else []

    @property
    def events(self) -> List[DcopEvent]:
        return list(self._events)

    def add_event(self, event: DcopEvent) -> "Scenario":
        self._events.append(event)
        return self

    def __iter__(self):
        return iter(self._events)

    def __len__(self):
        return len(self._events)

    def __repr__(self):
        return f"Scenario({len(self._events)} events)"
