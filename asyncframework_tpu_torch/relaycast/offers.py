"""ChildRegistry: the ONE relay-child registry + offer fan-out.

Both offer senders -- the PS root's offer loop (``parallel/ps_dcn.py``)
and every interior :class:`~asyncframework_tpu_torch.relaycast.node.RelayNode`
-- need the same machinery: a fanout-bounded registry of learned child
endpoints, LRU semantics so a child that stopped subscribing is
displaced by one that still does (a deep node that fell back to the
root ONCE must not squat a root offer slot forever -- its slot goes to
the planned direct child the moment that child registers), strike
bookkeeping that drops a dead child after a few failed offers, and the
short-timeout connect-send-recv-close offer send itself.  One class so
a fix lands once.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import List, Tuple

from asyncframework_tpu_torch.net import frame as _frame
from asyncframework_tpu_torch.relaycast import metrics as rmetrics

#: consecutive offer failures before a child is dropped (its next
#: registering fetch/subscribe re-adds it)
OFFER_STRIKES = 3


class ChildRegistry:
    """Fanout-bounded LRU registry of relay-child endpoints."""

    def __init__(self, cap: int, timeout_s: float = 0.5):
        self.cap = max(1, int(cap))
        self.timeout_s = float(timeout_s)
        #: (host, port) -> consecutive offer failures, LRU order --
        #: front is the child that registered/re-registered longest ago
        self._children: "OrderedDict[Tuple[str, int], int]" = OrderedDict()
        self._lock = threading.Lock()

    def register(self, host: str, port: int) -> None:
        """Record (or refresh) a child.  At capacity the least-recently
        registering child is EVICTED in its favor: registration renews
        on every fetch/subscribe, so live children keep their slots and
        a child that re-homed away is displaced by one still here."""
        key = (host, int(port))
        with self._lock:
            if key in self._children:
                self._children[key] = 0
                self._children.move_to_end(key)
                return
            while len(self._children) >= self.cap:
                self._children.popitem(last=False)
                rmetrics.bump("children_evicted")
            self._children[key] = 0

    def children(self) -> List[Tuple[str, int]]:
        with self._lock:
            return list(self._children.keys())

    def offer(self, hdr: dict) -> int:
        """Send ``hdr`` (a RELAY_OFFER) to every registered child;
        returns the delivered count.  Sends happen OUTSIDE the lock
        with short timeouts; ``OFFER_STRIKES`` consecutive failures
        drop a child."""
        delivered = 0
        for key in self.children():
            try:
                sock = _frame.connect(key, timeout=self.timeout_s)
                try:
                    _frame.send_msg(sock, hdr)
                    _frame.recv_msg(sock)
                finally:
                    sock.close()
                delivered += 1
                rmetrics.bump("offers_sent")
                with self._lock:
                    if key in self._children:
                        self._children[key] = 0
            except (ConnectionError, OSError):
                with self._lock:
                    strikes = self._children.get(key)
                    if strikes is not None:
                        if strikes + 1 >= OFFER_STRIKES:
                            del self._children[key]
                            rmetrics.bump("children_dropped")
                        else:
                            self._children[key] = strikes + 1
        return delivered
