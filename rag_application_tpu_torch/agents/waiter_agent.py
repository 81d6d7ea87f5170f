"""WaiterAgent: the reference's domain-demo agent.

Copy of `rag_application_tpu/agents/waiter_agent.py`.

Parity: AgentAPI/app/agents/waiter_agent/ (~900 LoC) — a restaurant
assistant with a menu/order toolset and YAML-driven prompts, used to
demonstrate building a vertical agent on the BaseAgent kernel. This port
keeps the same shape (domain tools + prompt manager + BaseAgent) at demo
scale; its real purpose is documenting the recipe for vertical agents.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..llm.router import LLMRouter
from ..tools.registry import Tool
from . import register_agent
from .base_agent import BaseAgent

MENU = {
    "margherita pizza": {"price": 12.0, "category": "mains", "vegetarian": True},
    "spaghetti carbonara": {"price": 14.5, "category": "mains", "vegetarian": False},
    "caesar salad": {"price": 9.0, "category": "starters", "vegetarian": False},
    "bruschetta": {"price": 7.5, "category": "starters", "vegetarian": True},
    "tiramisu": {"price": 8.0, "category": "desserts", "vegetarian": True},
}

PROMPTS = {
    "system": ("You are an attentive restaurant waiter. Use the tools to "
               "answer menu questions and manage the guest's order. Never "
               "invent dishes."),
}


@dataclass
class OrderState:
    items: List[Dict] = field(default_factory=list)

    def total(self) -> float:
        return sum(i["price"] * i["quantity"] for i in self.items)


@register_agent("waiter_agent")
class WaiterAgent(BaseAgent):
    agent_id = "waiter_agent"

    def __init__(self, llm: Optional[LLMRouter] = None, *,
                 menu: Optional[Dict] = None, **kw):
        kw.setdefault("system_prompt", PROMPTS["system"])
        super().__init__(llm, **kw)
        self.menu = menu or dict(MENU)
        self.orders: Dict[str, OrderState] = {}
        self.bind_tools(self._build_tools())

    def _order(self, table: str) -> OrderState:
        return self.orders.setdefault(table, OrderState())

    def _build_tools(self) -> List[Tool]:
        def browse_menu(category: str = "", vegetarian_only: bool = False):
            out = []
            for name, item in self.menu.items():
                # case-insensitive like the dish lookup — the model
                # naturally capitalizes ('Mains') and got an empty menu
                if category and item["category"] != category.lower():
                    continue
                if vegetarian_only and not item["vegetarian"]:
                    continue
                out.append({"name": name, **item})
            return out

        def add_to_order(table: str, dish: str, quantity: int = 1):
            item = self.menu.get(dish.lower())
            if item is None:
                return {"error": f"'{dish}' is not on the menu"}
            self._order(table).items.append(
                {"dish": dish.lower(), "quantity": quantity,
                 "price": item["price"]})
            return {"added": dish, "quantity": quantity}

        def remove_from_order(table: str, dish: str):
            # read path: .get, not _order's setdefault — queries for
            # unknown/typo'd tables must not create phantom orders
            order = self.orders.get(table)
            if order is None:
                return {"removed": 0}
            before = len(order.items)
            order.items = [i for i in order.items if i["dish"] != dish.lower()]
            return {"removed": before - len(order.items)}

        def get_order(table: str):
            order = self.orders.get(table) or OrderState()
            return {"items": order.items, "total": order.total()}

        def checkout(table: str):
            order = self.orders.pop(table, OrderState())
            return {"total": order.total(), "items": len(order.items),
                    "status": "paid"}

        return [
            Tool("browse_menu", "List menu items, optionally filtered.",
                 {"type": "object", "properties": {
                     "category": {"type": "string", "default": ""},
                     "vegetarian_only": {"type": "boolean", "default": False}}},
                 browse_menu),
            Tool("add_to_order", "Add a dish to a table's order.",
                 {"type": "object", "properties": {
                     "table": {"type": "string"},
                     "dish": {"type": "string"},
                     "quantity": {"type": "integer", "default": 1}},
                  "required": ["table", "dish"]}, add_to_order),
            Tool("remove_from_order", "Remove a dish from an order.",
                 {"type": "object", "properties": {
                     "table": {"type": "string"}, "dish": {"type": "string"}},
                  "required": ["table", "dish"]}, remove_from_order),
            Tool("get_order", "Show a table's current order and total.",
                 {"type": "object", "properties": {
                     "table": {"type": "string"}}, "required": ["table"]},
                 get_order),
            Tool("checkout", "Close a table's order.",
                 {"type": "object", "properties": {
                     "table": {"type": "string"}}, "required": ["table"]},
                 checkout),
        ]
