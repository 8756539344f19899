"""The object model: six agent-orchestration kinds plus Secret, Event and
Lease (the port's copy of the reference's ``api/resources.py``).

The kinds are rebuilt from the upstream CRDs: LLM, Agent, Task, ToolCall,
MCPServer and ContactChannel, plus the Kubernetes-native kinds the control
plane leans on (Secret for API keys, Event for user-facing history, Lease
for distributed locking), which the in-tree kernel provides.

Each model is a dataclass (``schema.APIModel``) with the reference's fields,
defaults, ``Literal`` checks and bounds, so the same manifest gives the same
storage document (snake_case) and manifest form (camelCase) in both
packages. The message types and ``BaseConfig`` are ``engine/types.py``'s,
re-exported here: one type per concept.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Literal, Optional

from ..engine.types import BaseConfig, Message, MessageToolCall, Role, ToolCallFunction
from ..schema import APIModel, bounded
from .meta import Resource


@dataclass(kw_only=True)
class SpanContext(APIModel):
    """Persisted trace root so one logical trace spans many reconciles."""

    trace_id: str = ""
    span_id: str = ""


# ---------------------------------------------------------------------------
# Secret (kernel-provided equivalent of core/v1 Secret)
# ---------------------------------------------------------------------------


@dataclass(kw_only=True)
class SecretSpec(APIModel):
    data: dict[str, str] = field(default_factory=dict)


@dataclass(kw_only=True)
class Secret(Resource):
    kind: str = "Secret"
    spec: SecretSpec = field(default_factory=SecretSpec)


@dataclass(kw_only=True)
class SecretKeyRef(APIModel):
    """APIKeySource (llm_types.go:34-38) / env-from-secret (mcpserver_types.go:41-61)."""

    name: str
    key: str


# ---------------------------------------------------------------------------
# LLM (llm_types.go)
# ---------------------------------------------------------------------------

LLMProvider = Literal["openai", "anthropic", "mistral", "google", "vertex", "tpu", "mock"]


@dataclass(kw_only=True)
class TPUProviderConfig(APIModel):
    """The in-process serving engine's config (``provider: tpu``; the name
    is the reference's, the engine is ``engine/engine.py``).

    The engine is process-wide and built before the control plane starts;
    the LLM controller holds the parallelism and quantization fields
    against the live engine (declarative intent), and the factory passes
    the timeouts and ``overlap_tool_calls`` to the client. ``prefill_chunk``
    and ``token_budget`` are the engine's knobs, set where the engine is
    built (``run --tpu-prefill-chunk/--tpu-token-budget``), not from a
    manifest, as in the reference. So are the host KV tier's knobs
    (``host_kv_bytes``, ``host_prefetch``: ``run --tpu-host-kv-bytes/
    --tpu-host-prefetch``); the fields are kept so the reference's
    manifests load unchanged, and nothing reads them, as in the reference.
    """

    checkpoint: Optional[str] = None
    preset: Optional[str] = None
    tensor_parallelism: int = 0  # 0 = every rank left after sp
    context_parallelism: int = 1  # sp ranks (context-parallel serving)
    expert_parallelism: int = 1  # ep ranks (MoE; not in the port's engine)
    max_sequences: int = 64
    max_context: int = 8192
    page_size: int = 16
    # legacy spelling of quantize_weights; either selects int8 weights
    quantization: Optional[Literal["int8"]] = None
    quantize_weights: bool = False
    # int8 KV pages with f32 scales; relaxes greedy byte identity
    quantize_kv: bool = False
    # generation timeout, counted from slot admission (not submit)
    request_timeout_seconds: float = bounded(30.0, gt=0)
    # cap on the submit -> slot-admission wait
    queue_timeout_seconds: float = bounded(600.0, gt=0)
    # hand each tool call to the caller the moment its arguments close
    overlap_tool_calls: bool = True
    prefill_chunk: int = bounded(0, ge=0)
    token_budget: int = bounded(0, ge=0)
    host_kv_bytes: int = bounded(0, ge=0)
    host_prefetch: bool = True


@dataclass(kw_only=True)
class OpenAIProviderConfig(APIModel):
    """OpenAI-specific options (llm_types.go:74-87)."""

    organization: str = ""  # sent as the OpenAI-Organization header
    api_type: Literal["OPEN_AI", "AZURE", "AZURE_AD"] = "OPEN_AI"
    api_version: str = ""  # required for Azure API types (e.g. "2023-05-15")

    def validate_model(self) -> None:
        if self.api_type in ("AZURE", "AZURE_AD") and not self.api_version:
            raise ValueError(f"apiType {self.api_type} requires apiVersion")


@dataclass(kw_only=True)
class AnthropicProviderConfig(APIModel):
    """Anthropic-specific options (llm_types.go:89-95)."""

    anthropic_beta_header: str = ""  # sent as the anthropic-beta header


@dataclass(kw_only=True)
class VertexProviderConfig(APIModel):
    """Vertex AI options (llm_types.go:97-107): both fields are required —
    the endpoint is project/region-scoped. Auth is a service-account JSON
    credential (apiKeyFrom secret) exchanged for an OAuth2 access token
    (langchaingo_client.go:65-70 WithCredentialsJSON equivalent)."""

    cloud_project: str
    cloud_location: str


@dataclass(kw_only=True)
class MistralProviderConfig(APIModel):
    """Mistral-specific options (llm_types.go:109-123)."""

    max_retries: Optional[int] = bounded(None, ge=0)
    timeout: Optional[int] = bounded(None, ge=1)  # seconds
    random_seed: Optional[int] = None  # deterministic sampling


@dataclass(kw_only=True)
class GoogleProviderConfig(APIModel):
    """Google AI (Gemini API) options (llm_types.go:125-133)."""

    cloud_project: str = ""
    cloud_location: str = ""


@dataclass(kw_only=True)
class LLMSpec(APIModel):
    provider: LLMProvider
    api_key_from: Optional[SecretKeyRef] = None
    parameters: BaseConfig = field(default_factory=BaseConfig)
    tpu: Optional[TPUProviderConfig] = None
    # Typed per-provider blocks (llm_types.go:135-141 ProviderConfig);
    # validated by the LLM controller before the live probe.
    openai: Optional[OpenAIProviderConfig] = None
    anthropic: Optional[AnthropicProviderConfig] = None
    vertex: Optional[VertexProviderConfig] = None
    mistral: Optional[MistralProviderConfig] = None
    google: Optional[GoogleProviderConfig] = None
    # Free-form extras with no reference analogue (e.g. the TPU provider's
    # tool_choice / force_json_tools); typed fields take precedence.
    provider_config: dict[str, Any] = field(default_factory=dict)


@dataclass(kw_only=True)
class LLMStatus(APIModel):
    ready: bool = False
    status: Literal["", "Ready", "Error", "Pending"] = ""
    status_detail: str = ""


@dataclass(kw_only=True)
class LLM(Resource):
    kind: str = "LLM"
    spec: LLMSpec
    status: LLMStatus = field(default_factory=LLMStatus)


# ---------------------------------------------------------------------------
# ContactChannel (contactchannel_types.go)
# ---------------------------------------------------------------------------


@dataclass(kw_only=True)
class SlackChannelConfig(APIModel):
    channel_or_user_id: str = ""
    context_about_channel_or_user: str = ""


@dataclass(kw_only=True)
class EmailChannelConfig(APIModel):
    address: str = ""
    context_about_user: str = ""


@dataclass(kw_only=True)
class ContactChannelSpec(APIModel):
    type: Literal["slack", "email"]
    api_key_from: Optional[SecretKeyRef] = None
    channel_api_key_from: Optional[SecretKeyRef] = None
    channel_id: Optional[str] = None
    slack: Optional[SlackChannelConfig] = None
    email: Optional[EmailChannelConfig] = None


@dataclass(kw_only=True)
class ContactChannelStatus(APIModel):
    ready: bool = False
    status: Literal["", "Ready", "Error", "Pending"] = ""
    status_detail: str = ""


@dataclass(kw_only=True)
class ContactChannel(Resource):
    kind: str = "ContactChannel"
    spec: ContactChannelSpec
    status: ContactChannelStatus = field(default_factory=ContactChannelStatus)


# ---------------------------------------------------------------------------
# MCPServer (mcpserver_types.go)
# ---------------------------------------------------------------------------


@dataclass(kw_only=True)
class EnvVar(APIModel):
    name: str
    value: Optional[str] = None
    value_from: Optional[SecretKeyRef] = None


@dataclass(kw_only=True)
class ResourceRequirements(APIModel):
    """Subprocess resource control (mcpserver_types.go:30-39). The reference
    forwards these to the k8s pod spec; standalone, ``limits.memory`` is
    enforced on the stdio subprocess via RLIMIT_AS (k8s quantity strings:
    "512Mi", "1Gi", ...). CPU limits need cgroups and are recorded but not
    enforced."""

    requests: dict[str, str] = field(default_factory=dict)
    limits: dict[str, str] = field(default_factory=dict)


@dataclass(kw_only=True)
class MCPServerSpec(APIModel):
    transport: Literal["stdio", "http"]
    command: Optional[str] = None
    args: list[str] = field(default_factory=list)
    env: list[EnvVar] = field(default_factory=list)
    url: Optional[str] = None
    resources: Optional[ResourceRequirements] = None
    # Gates ALL tools of this server behind human approval
    # (mcpserver_types.go:30-39).
    approval_contact_channel: Optional[str] = None


@dataclass(kw_only=True)
class MCPTool(APIModel):
    name: str
    description: str = ""
    input_schema: dict[str, Any] = field(default_factory=dict)


@dataclass(kw_only=True)
class MCPServerStatus(APIModel):
    connected: bool = False
    status: Literal["", "Ready", "Error", "Pending"] = ""
    status_detail: str = ""
    tools: list[MCPTool] = field(default_factory=list)


@dataclass(kw_only=True)
class MCPServer(Resource):
    kind: str = "MCPServer"
    spec: MCPServerSpec
    status: MCPServerStatus = field(default_factory=MCPServerStatus)


# ---------------------------------------------------------------------------
# Agent (agent_types.go)
# ---------------------------------------------------------------------------


@dataclass(kw_only=True)
class LocalObjectRef(APIModel):
    name: str


@dataclass(kw_only=True)
class ContextPolicy(APIModel):
    """Long-conversation control (no reference analogue: the reference
    stores the full window unbounded and is limited only by etcd object
    size — SURVEY.md §5 'Long-context'). ``max_messages`` caps what is SENT
    to the LLM (the checkpointed history in status stays complete); elided
    spans are replaced with a marker message. Compaction respects tool-call
    protocol boundaries (a tool result is never sent without the assistant
    message that requested it)."""

    max_messages: int = 0  # 0 = unlimited


@dataclass(kw_only=True)
class AgentSpec(APIModel):
    llm_ref: LocalObjectRef
    system: str
    description: str = ""  # used in the delegate-tool description
    mcp_servers: list[LocalObjectRef] = field(default_factory=list)
    human_contact_channels: list[LocalObjectRef] = field(default_factory=list)
    sub_agents: list[LocalObjectRef] = field(default_factory=list)
    context_policy: Optional[ContextPolicy] = None


@dataclass(kw_only=True)
class ResolvedMCPServer(APIModel):
    name: str
    tools: list[str] = field(default_factory=list)


@dataclass(kw_only=True)
class ResolvedSubAgent(APIModel):
    name: str
    description: str = ""


@dataclass(kw_only=True)
class AgentStatus(APIModel):
    """Caches *resolved* dependencies (agent_types.go:53-102)."""

    ready: bool = False
    status: Literal["", "Ready", "Error", "Pending"] = ""
    status_detail: str = ""
    valid_mcp_servers: list[ResolvedMCPServer] = field(default_factory=list)
    valid_human_contact_channels: list[str] = field(default_factory=list)
    valid_sub_agents: list[ResolvedSubAgent] = field(default_factory=list)


@dataclass(kw_only=True)
class Agent(Resource):
    kind: str = "Agent"
    spec: AgentSpec
    status: AgentStatus = field(default_factory=AgentStatus)


# ---------------------------------------------------------------------------
# Task (task_types.go)
# ---------------------------------------------------------------------------

# Phases (task_types.go:170-193). The reference declares 9 but only 7 are
# reachable (SendContextWindowToLLM / CheckingToolCalls / ErrorBackoff are
# never set by the state machine — SURVEY.md §1); we declare the reachable set.
TASK_PHASE_INITIALIZING = "Initializing"
TASK_PHASE_PENDING = "Pending"
TASK_PHASE_READY_FOR_LLM = "ReadyForLLM"
TASK_PHASE_TOOL_CALLS_PENDING = "ToolCallsPending"
TASK_PHASE_FINAL_ANSWER = "FinalAnswer"
TASK_PHASE_FAILED = "Failed"

TaskPhase = Literal[
    "",
    "Initializing",
    "Pending",
    "ReadyForLLM",
    "ToolCallsPending",
    "FinalAnswer",
    "Failed",
]

# Label keys for fan-out/fan-in joins (task/state_machine.go:296-299, 713-717).
LABEL_TASK = "acp.tpu/task"
LABEL_TOOL_CALL_REQUEST = "acp.tpu/toolcallrequest"
LABEL_PARENT_TOOLCALL = "acp.tpu/parent-toolcall"
LABEL_AGENT = "acp.tpu/agent"
LABEL_V1BETA3 = "acp.tpu/v1beta3"


@dataclass(kw_only=True)
class TaskSpec(APIModel):
    agent_ref: LocalObjectRef
    # Exactly one of user_message / context_window (task_types.go:24-54).
    user_message: Optional[str] = None
    context_window: Optional[list[Message]] = None
    contact_channel_ref: Optional[LocalObjectRef] = None
    channel_token_from: Optional[SecretKeyRef] = None
    thread_id: Optional[str] = None


@dataclass(kw_only=True)
class TaskStatus(APIModel):
    phase: TaskPhase = ""
    status: Literal["", "Ready", "Error", "Pending"] = ""
    status_detail: str = ""
    # THE source of truth for the conversation (task_types.go:137-139).
    context_window: list[Message] = field(default_factory=list)
    message_count: int = 0
    output: str = ""
    user_msg_preview: str = ""  # first 50 chars (validation/task_validation.go)
    error: str = ""
    span_context: Optional[SpanContext] = None
    tool_call_request_id: Optional[str] = None


@dataclass(kw_only=True)
class Task(Resource):
    kind: str = "Task"
    spec: TaskSpec
    status: TaskStatus = field(default_factory=TaskStatus)


# ---------------------------------------------------------------------------
# ToolCall (toolcall_types.go)
# ---------------------------------------------------------------------------

TOOL_TYPE_MCP = "MCP"
TOOL_TYPE_HUMAN_CONTACT = "HumanContact"
TOOL_TYPE_DELEGATE = "DelegateToAgent"

ToolType = Literal["MCP", "HumanContact", "DelegateToAgent"]

# Phases (toolcall_types.go:89-116).
TC_PHASE_PENDING = "Pending"
TC_PHASE_RUNNING = "Running"
TC_PHASE_SUCCEEDED = "Succeeded"
TC_PHASE_FAILED = "Failed"
TC_PHASE_AWAITING_HUMAN_INPUT = "AwaitingHumanInput"
TC_PHASE_AWAITING_SUB_AGENT = "AwaitingSubAgent"
TC_PHASE_AWAITING_HUMAN_APPROVAL = "AwaitingHumanApproval"
TC_PHASE_READY_TO_EXECUTE = "ReadyToExecuteApprovedTool"
TC_PHASE_ERR_REQUESTING_APPROVAL = "ErrorRequestingHumanApproval"
TC_PHASE_ERR_REQUESTING_INPUT = "ErrorRequestingHumanInput"
TC_PHASE_REJECTED = "ToolCallRejected"

ToolCallPhase = Literal[
    "",
    "Pending",
    "Running",
    "Succeeded",
    "Failed",
    "AwaitingHumanInput",
    "AwaitingSubAgent",
    "AwaitingHumanApproval",
    "ReadyToExecuteApprovedTool",
    "ErrorRequestingHumanApproval",
    "ErrorRequestingHumanInput",
    "ToolCallRejected",
]


@dataclass(kw_only=True)
class ToolCallSpec(APIModel):
    tool_call_id: str
    task_ref: LocalObjectRef
    tool_ref: LocalObjectRef  # name is "server__tool" / "delegate_to_agent__x" / channel tool
    tool_type: ToolType
    arguments: str = "{}"


@dataclass(kw_only=True)
class ToolCallStatus(APIModel):
    phase: ToolCallPhase = ""
    status: Literal["", "Ready", "Error", "Pending", "Succeeded"] = ""
    status_detail: str = ""
    external_call_id: str = ""
    result: str = ""
    error: str = ""
    span_context: Optional[SpanContext] = None
    start_time: Optional[float] = None
    completion_time: Optional[float] = None


@dataclass(kw_only=True)
class ToolCall(Resource):
    kind: str = "ToolCall"
    spec: ToolCallSpec
    status: ToolCallStatus = field(default_factory=ToolCallStatus)


# ---------------------------------------------------------------------------
# Event (kernel-provided equivalent of core/v1 Event)
# ---------------------------------------------------------------------------


@dataclass(kw_only=True)
class EventSpec(APIModel):
    involved_kind: str = ""
    involved_name: str = ""
    involved_uid: str = ""
    type: Literal["Normal", "Warning"] = "Normal"
    reason: str = ""
    message: str = ""
    count: int = 1
    last_timestamp: float = 0.0


@dataclass(kw_only=True)
class Event(Resource):
    kind: str = "Event"
    spec: EventSpec = field(default_factory=EventSpec)


# ---------------------------------------------------------------------------
# Lease (kernel-provided equivalent of coordination.k8s.io/v1 Lease)
# ---------------------------------------------------------------------------


@dataclass(kw_only=True)
class LeaseSpec(APIModel):
    holder_identity: str = ""
    lease_duration_seconds: float = 30.0
    acquire_time: float = 0.0
    renew_time: float = 0.0
    # fencing token (k8s leaseTransitions analogue): bumped every time the
    # lease changes hands, NEVER on renewal. A write fenced on (holder,
    # epoch) is rejected once a new holder adopts — a deposed-but-alive
    # leader's in-flight writes cannot land on a stale view.
    epoch: int = 0


@dataclass(kw_only=True)
class Lease(Resource):
    kind: str = "Lease"
    spec: LeaseSpec = field(default_factory=LeaseSpec)


# ---------------------------------------------------------------------------
# Kind registry (deserialization from the store's canonical dict form)
# ---------------------------------------------------------------------------

KINDS: dict[str, type[Resource]] = {
    "Secret": Secret,
    "LLM": LLM,
    "ContactChannel": ContactChannel,
    "MCPServer": MCPServer,
    "Agent": Agent,
    "Task": Task,
    "ToolCall": ToolCall,
    "Event": Event,
    "Lease": Lease,
}


def from_doc(doc: dict[str, Any]) -> Resource:
    cls = KINDS[doc["kind"]]
    return cls.model_validate(doc)


__all__ = [
    # message model
    "Message", "MessageToolCall", "ToolCallFunction", "Role", "SpanContext",
    # kinds
    "Secret", "SecretSpec", "SecretKeyRef",
    "LLM", "LLMSpec", "LLMStatus", "LLMProvider", "BaseConfig", "TPUProviderConfig",
    "ContactChannel", "ContactChannelSpec", "ContactChannelStatus",
    "SlackChannelConfig", "EmailChannelConfig",
    "MCPServer", "MCPServerSpec", "MCPServerStatus", "MCPTool", "EnvVar",
    "Agent", "AgentSpec", "AgentStatus", "ContextPolicy",
    "ResolvedMCPServer", "ResolvedSubAgent",
    "LocalObjectRef",
    "Task", "TaskSpec", "TaskStatus", "TaskPhase",
    "ToolCall", "ToolCallSpec", "ToolCallStatus", "ToolCallPhase", "ToolType",
    "Event", "EventSpec",
    "Lease", "LeaseSpec",
    # phase/label constants
    "TASK_PHASE_INITIALIZING", "TASK_PHASE_PENDING", "TASK_PHASE_READY_FOR_LLM",
    "TASK_PHASE_TOOL_CALLS_PENDING", "TASK_PHASE_FINAL_ANSWER", "TASK_PHASE_FAILED",
    "TC_PHASE_PENDING", "TC_PHASE_RUNNING", "TC_PHASE_SUCCEEDED", "TC_PHASE_FAILED",
    "TC_PHASE_AWAITING_HUMAN_INPUT", "TC_PHASE_AWAITING_SUB_AGENT",
    "TC_PHASE_AWAITING_HUMAN_APPROVAL", "TC_PHASE_READY_TO_EXECUTE",
    "TC_PHASE_ERR_REQUESTING_APPROVAL", "TC_PHASE_ERR_REQUESTING_INPUT",
    "TC_PHASE_REJECTED",
    "TOOL_TYPE_MCP", "TOOL_TYPE_HUMAN_CONTACT", "TOOL_TYPE_DELEGATE",
    "LABEL_TASK", "LABEL_TOOL_CALL_REQUEST", "LABEL_PARENT_TOOLCALL",
    "LABEL_AGENT", "LABEL_V1BETA3",
    # registry
    "KINDS", "from_doc",
]
