"""Deterministic bilingual KB corpus generator for eval + training (copy
of ``cmw_rag_tpu/eval/corpus_gen.py``; stdlib only, the same articles,
kbIds, queries and training pairs for the same seeds).

The reference benchmarks on a production corpus of 8,231 real articles plus
52 human-judged bilingual queries (cmw-rag
``rag_engine/docs/analysis/20260321-reranker-benchmark-final.md:39-66``).
Neither is shippable here, so this module generates a structured stand-in:
a low-code-platform knowledge base of **(topic × facet × language ×
product-version)** articles with distinctive per-topic terminology, rich
enough that retrieval quality is *learnable* (a trained encoder must beat a
random one) and *measurable* (graded judgments derive from the generation
structure; the eval queries themselves are hand-written in
``judged_queries.py`` and judged by the dataset author).

Everything is deterministic in (topics, facets, versions, seed): kbIds are
stable across runs, so the committed judged-query JSON stays valid.
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Iterator

# --------------------------------------------------------------------- topics
# slug, RU name (nominative), EN name, RU terminology, EN terminology.
# Terminology lists give each topic a distinctive lexical field — that is
# what makes the retrieval task learnable rather than memorizable.
TOPICS: list[tuple[str, str, str, list[str], list[str]]] = [
    ("process-designer", "дизайнер процессов", "process designer",
     ["схема процесса", "переход", "шлюз", "дорожка", "событие запуска",
      "диаграмма", "исполнитель шага"],
     ["process diagram", "transition", "gateway", "swimlane", "start event",
      "flow chart", "step assignee"]),
    ("forms", "формы", "forms",
     ["поле формы", "вкладка", "виджет", "маска ввода", "обязательное поле",
      "скрытие полей", "валидация"],
     ["form field", "tab", "widget", "input mask", "required field",
      "field visibility", "validation"]),
    ("records", "записи и таблицы", "records and tables",
     ["таблица данных", "атрибут записи", "связанная запись", "фильтр таблицы",
      "карточка записи", "сортировка", "колонка"],
     ["data table", "record attribute", "linked record", "table filter",
      "record card", "sorting", "column"]),
    ("accounts", "учётные записи", "user accounts",
     ["учётная запись", "профиль пользователя", "пароль", "блокировка",
      "электронная почта", "активация", "логин"],
     ["user account", "user profile", "password", "lockout",
      "email address", "activation", "login name"]),
    ("roles-permissions", "роли и права доступа", "roles and permissions",
     ["роль", "право доступа", "группа пользователей", "область видимости",
      "запрет на чтение", "администратор", "наследование прав"],
     ["role", "access permission", "user group", "visibility scope",
      "read restriction", "administrator", "permission inheritance"]),
    ("notifications", "уведомления", "notifications",
     ["шаблон уведомления", "рассылка", "подписка", "триггер уведомления",
      "письмо", "дайджест", "получатель"],
     ["notification template", "mailing", "subscription", "notification trigger",
      "email message", "digest", "recipient"]),
    ("templates", "шаблоны документов", "document templates",
     ["шаблон печатной формы", "подстановка значений", "генерация документа",
      "docx шаблон", "метка поля", "выгрузка в pdf", "бланк"],
     ["print form template", "value substitution", "document generation",
      "docx template", "field placeholder", "pdf export", "letterhead"]),
    ("rest-api", "REST API", "REST API",
     ["токен доступа", "метод api", "запрос post", "ответ json",
      "конечная точка", "авторизация запроса", "код ошибки"],
     ["access token", "api method", "post request", "json response",
      "endpoint", "request authorization", "error code"]),
    ("webhooks", "веб-хуки", "webhooks",
     ["веб-хук", "обратный вызов", "подпись запроса", "повторная доставка",
      "внешняя система", "полезная нагрузка", "обработчик события"],
     ["webhook", "callback", "request signature", "redelivery",
      "external system", "payload", "event handler"]),
    ("import-export", "импорт и экспорт данных", "data import and export",
     ["импорт из csv", "сопоставление колонок", "экспорт в excel",
      "кодировка файла", "разделитель", "массовая загрузка", "шаблон импорта"],
     ["csv import", "column mapping", "excel export",
      "file encoding", "delimiter", "bulk upload", "import template"]),
    ("backup", "резервное копирование", "backup and restore",
     ["резервная копия", "восстановление базы", "расписание копирования",
      "хранилище копий", "контрольная точка", "дамп базы", "перенос сервера"],
     ["backup copy", "database restore", "backup schedule",
      "backup storage", "checkpoint", "database dump", "server migration"]),
    ("reports", "отчёты", "reports",
     ["конструктор отчётов", "группировка строк", "агрегатная функция",
      "диаграмма", "период отчёта", "сводная таблица", "выгрузка отчёта"],
     ["report builder", "row grouping", "aggregate function",
      "chart", "report period", "pivot table", "report export"]),
    ("dashboards", "панели мониторинга", "dashboards",
     ["панель мониторинга", "виджет показателя", "плитка", "обновление данных",
      "настройка раскладки", "счётчик", "индикатор"],
     ["dashboard", "metric widget", "tile", "data refresh",
      "layout configuration", "counter", "indicator"]),
    ("calendars", "календари", "calendars",
     ["производственный календарь", "рабочие дни", "праздничные дни",
      "смена", "часовой пояс", "расписание", "исключение из графика"],
     ["business calendar", "working days", "public holidays",
      "shift", "time zone", "schedule", "calendar exception"]),
    ("email-integration", "интеграция с почтой", "email integration",
     ["почтовый сервер", "smtp", "imap", "ящик входящих", "правило разбора",
      "вложение письма", "отправитель"],
     ["mail server", "smtp", "imap", "inbox", "parsing rule",
      "mail attachment", "sender"]),
    ("ldap-sso", "LDAP и единый вход", "LDAP and single sign-on",
     ["ldap каталог", "синхронизация пользователей", "единый вход",
      "saml", "служба каталогов", "доменная учётная запись", "сертификат"],
     ["ldap directory", "user synchronization", "single sign-on",
      "saml", "directory service", "domain account", "certificate"]),
    ("localization", "локализация", "localization",
     ["язык интерфейса", "перевод строк", "локаль", "формат даты",
      "мультиязычность", "словарь переводов", "региональные настройки"],
     ["interface language", "string translation", "locale", "date format",
      "multilingual support", "translation dictionary", "regional settings"]),
    ("performance", "производительность", "performance",
     ["время отклика", "кэширование", "нагрузка на сервер", "медленный запрос",
      "оптимизация", "индекс базы данных", "мониторинг ресурсов"],
     ["response time", "caching", "server load", "slow query",
      "optimization", "database index", "resource monitoring"]),
    ("licensing", "лицензирование", "licensing",
     ["лицензионный ключ", "число пользователей", "срок действия лицензии",
      "активация лицензии", "именная лицензия", "конкурентная лицензия",
      "продление"],
     ["license key", "user count", "license expiration",
      "license activation", "named license", "concurrent license",
      "renewal"]),
    ("mobile", "мобильный доступ", "mobile access",
     ["мобильное приложение", "адаптивный интерфейс", "push уведомление",
      "офлайн режим", "сканирование штрихкода", "планшет", "мобильная форма"],
     ["mobile app", "responsive interface", "push notification",
      "offline mode", "barcode scanning", "tablet", "mobile form"]),
    ("scripts-expressions", "выражения и скрипты", "expressions and scripts",
     ["вычисляемое выражение", "формула", "условие ветвления", "переменная процесса",
      "функция строки", "математическая операция", "скрипт на c#"],
     ["calculated expression", "formula", "branching condition", "process variable",
      "string function", "math operation", "c# script"]),
    ("version-upgrade", "обновление версии", "version upgrade",
     ["установка обновления", "миграция данных", "примечания к выпуску",
      "совместимость версий", "откат обновления", "установщик", "патч"],
     ["update installation", "data migration", "release notes",
      "version compatibility", "update rollback", "installer", "patch"]),
    ("audit-log", "журнал аудита", "audit log",
     ["журнал действий", "событие аудита", "история изменений", "автор изменения",
      "просмотр журнала", "срок хранения журнала", "выгрузка журнала"],
     ["action log", "audit event", "change history", "change author",
      "log viewer", "log retention", "log export"]),
    ("attachments", "вложения файлов", "file attachments",
     ["вложение", "размер файла", "предпросмотр", "версия файла",
      "ограничение форматов", "хранилище файлов", "загрузка файла"],
     ["attachment", "file size", "preview", "file version",
      "format restriction", "file storage", "file upload"]),
    ("tasks", "задачи", "tasks",
     ["постановка задачи", "срок выполнения", "исполнитель", "приоритет",
      "делегирование", "чек-лист", "повторяющаяся задача"],
     ["task assignment", "due date", "assignee", "priority",
      "delegation", "checklist", "recurring task"]),
    ("comments-collab", "комментарии и обсуждения", "comments and collaboration",
     ["комментарий", "упоминание коллеги", "лента обсуждения", "ответ на комментарий",
      "закреплённое сообщение", "реакция", "цитирование"],
     ["comment", "mention a colleague", "discussion feed", "reply to a comment",
      "pinned message", "reaction", "quoting"]),
    ("search", "поиск по системе", "system search",
     ["поисковая строка", "полнотекстовый поиск", "поисковый фильтр",
      "результаты поиска", "поиск по вложениям", "синонимы", "релевантность"],
     ["search bar", "full-text search", "search filter",
      "search results", "attachment search", "synonyms", "relevance"]),
    ("archive", "архивирование", "archiving",
     ["архивная запись", "перенос в архив", "восстановление из архива",
      "политика хранения", "архивное хранилище", "срок архивации", "очистка"],
     ["archived record", "move to archive", "restore from archive",
      "retention policy", "archive storage", "archiving period", "cleanup"]),
    ("kanban-board", "канбан-доска", "kanban board",
     ["канбан-доска", "колонка статуса", "перетаскивание карточки",
      "лимит незавершённой работы", "свимлейн доски", "карточка задачи",
      "фильтр доски"],
     ["kanban board", "status column", "card drag and drop",
      "work-in-progress limit", "board swimlane", "task card",
      "board filter"]),
    ("sla", "соглашения об уровне сервиса", "service level agreements",
     ["метрика sla", "время реакции", "время решения", "эскалация",
      "нарушение sla", "рабочие часы поддержки", "приоритет обращения"],
     ["sla metric", "response time target", "resolution time", "escalation",
      "sla breach", "support business hours", "ticket priority"]),
    ("security-settings", "настройки безопасности", "security settings",
     ["политика паролей", "двухфакторная аутентификация", "сессия пользователя",
      "список разрешённых адресов", "журнал входов", "шифрование", "тайм-аут сессии"],
     ["password policy", "two-factor authentication", "user session",
      "ip allowlist", "sign-in log", "encryption", "session timeout"]),
    ("data-model", "модель данных", "data model",
     ["объект данных", "тип атрибута", "справочник", "связь один-ко-многим",
      "уникальный идентификатор", "вычисляемый атрибут", "схема данных"],
     ["data object", "attribute type", "dictionary", "one-to-many relation",
      "unique identifier", "calculated attribute", "data schema"]),
    ("printing", "печать", "printing",
     ["печатная форма", "предпросмотр печати", "настройка полей страницы",
      "ориентация страницы", "колонтитул", "печать списка", "принтер"],
     ["print form", "print preview", "page margin settings",
      "page orientation", "header and footer", "list printing", "printer"]),
    ("integrations-ext", "интеграции с внешними системами", "external integrations",
     ["коннектор", "обмен данными", "расписание синхронизации", "очередь сообщений",
      "сопоставление полей", "журнал обмена", "повторная отправка"],
     ["connector", "data exchange", "sync schedule", "message queue",
      "field mapping", "exchange log", "resend"]),
    ("document-flow", "документооборот", "document flow",
     ["регистрация документа", "лист согласования", "резолюция", "номенклатура дел",
      "электронная подпись", "входящий документ", "контроль исполнения"],
     ["document registration", "approval sheet", "resolution", "file nomenclature",
      "electronic signature", "incoming document", "execution control"]),
    ("onboarding", "обучение и адаптация", "onboarding and training",
     ["обучающий курс", "база знаний", "подсказка интерфейса", "видеоурок",
      "сценарий адаптации", "сертификация", "часто задаваемые вопросы"],
     ["training course", "knowledge base", "interface hint", "video tutorial",
      "onboarding scenario", "certification", "frequently asked questions"]),
    ("surveys", "опросы", "surveys",
     ["анкета опроса", "вопрос с вариантами", "шкала оценки",
      "анонимный ответ", "рассылка опроса", "итоги опроса",
      "обязательный вопрос"],
     ["survey form", "multiple-choice question", "rating scale",
      "anonymous response", "survey mailing", "survey results",
      "required question"]),
    ("contracts", "договоры", "contract management",
     ["карточка договора", "срок действия договора", "пролонгация",
      "контрагент", "сумма договора", "согласование договора",
      "реестр договоров"],
     ["contract card", "contract validity period", "prolongation",
      "counterparty", "contract amount", "contract approval",
      "contract register"]),
    ("service-catalog", "каталог услуг", "service catalog",
     ["карточка услуги", "категория услуги", "стоимость услуги",
      "заявка на услугу", "владелец услуги", "параметры услуги",
      "публикация услуги"],
     ["service card", "service category", "service cost",
      "service request", "service owner", "service parameters",
      "service publication"]),
    ("timesheets", "учёт рабочего времени", "time tracking",
     ["табель учёта", "трудозатраты", "списание часов", "норма часов",
      "сверхурочные", "отчёт по времени", "период табеля"],
     ["timesheet", "labor costs", "hour logging", "hour quota",
      "overtime", "time report", "timesheet period"]),
    ("crm", "клиентская база", "customer management",
     ["карточка клиента", "воронка продаж", "сделка", "контактное лицо",
      "история взаимодействий", "сегмент клиентов", "источник лида"],
     ["customer card", "sales funnel", "deal", "contact person",
      "interaction history", "customer segment", "lead source"]),
    ("inventory", "учёт оборудования", "asset inventory",
     ["карточка оборудования", "инвентарный номер", "списание оборудования",
      "передача техники", "склад", "срок гарантии", "инвентаризация"],
     ["asset card", "inventory number", "asset write-off",
      "equipment handover", "warehouse", "warranty period", "stocktaking"]),
    ("portal", "портал самообслуживания", "self-service portal",
     ["страница портала", "личный кабинет", "виджет портала",
      "публичная форма", "брендирование портала", "анонимный доступ",
      "раздел портала"],
     ["portal page", "personal account", "portal widget",
      "public form", "portal branding", "anonymous access",
      "portal section"]),
    ("org-structure", "оргструктура", "org structure",
     ["подразделение", "должность", "руководитель подразделения",
      "штатное расписание", "иерархия отделов", "перевод сотрудника",
      "замещение"],
     ["department", "job position", "department head",
      "staffing table", "department hierarchy", "employee transfer",
      "substitution"]),
    ("projects", "проекты", "project management",
     ["карточка проекта", "веха проекта", "план работ", "участник проекта",
      "диаграмма ганта", "загрузка команды", "статус проекта"],
     ["project card", "project milestone", "work plan", "project member",
      "gantt chart", "team workload", "project status"]),
    ("budgeting", "бюджетирование", "budgeting",
     ["статья бюджета", "лимит расходов", "заявка на расход",
      "факт и план", "период бюджета", "согласование расходов",
      "остаток бюджета"],
     ["budget line", "spending limit", "expense request",
      "actuals vs plan", "budget period", "expense approval",
      "budget balance"]),
    ("vacations", "отпуска и отсутствия", "absence management",
     ["заявка на отпуск", "график отпусков", "остаток дней", "больничный",
      "замещающий сотрудник", "перенос отпуска", "командировка"],
     ["vacation request", "vacation schedule", "remaining days",
      "sick leave", "substitute employee", "vacation reschedule",
      "business trip"]),
    ("themes", "оформление интерфейса", "branding and themes",
     ["цветовая схема", "логотип компании", "тема оформления",
      "шрифт интерфейса", "стартовая страница", "значок приложения",
      "тёмная тема"],
     ["color scheme", "company logo", "interface theme",
      "ui font", "start page", "application icon", "dark theme"]),
    ("gantt-chart", "диаграмма Ганта", "Gantt chart",
     ["шкала времени", "зависимость задач", "критический путь",
      "вехи проекта", "длительность этапа", "перетаскивание сроков",
      "базовый план"],
     ["timeline scale", "task dependency", "critical path",
      "project milestones", "phase duration", "drag-to-reschedule",
      "baseline plan"]),
    ("automation-rules", "правила автоматизации", "automation rules",
     ["условие срабатывания", "автоматическое действие", "изменение статуса",
      "назначение исполнителя", "правило по расписанию", "цепочка правил",
      "остановка правила"],
     ["trigger condition", "automatic action", "status change",
      "assignee auto-pick", "scheduled rule", "rule chain",
      "rule suspension"]),
    ("business-calendar", "производственный календарь", "business calendar",
     ["рабочие дни", "праздничные дни", "перенос выходных",
      "график смен", "рабочие часы", "региональный календарь",
      "учёт выходных в сроках"],
     ["working days", "public holidays", "weekend shifts",
      "shift schedule", "business hours", "regional calendar",
      "deadline skip of days off"]),
    ("escalations", "эскалации", "escalations",
     ["просрочка срока", "повышение приоритета", "переназначение руководителю",
      "цепочка эскалации", "таймер ожидания", "уровень поддержки",
      "автоматическая эскалация"],
     ["deadline breach", "priority bump", "reassign to manager",
      "escalation chain", "wait timer", "support tier",
      "automatic escalation"]),
    ("approvals-matrix", "матрица согласования", "approvals matrix",
     ["уровень согласования", "сумма договора", "замещающий согласант",
      "параллельное согласование", "кворум голосов", "делегирование решения",
      "таблица согласантов"],
     ["approval level", "contract amount", "deputy approver",
      "parallel approval", "vote quorum", "decision delegation",
      "approver table"]),
    ("digital-signature", "электронная подпись", "digital signature",
     ["квалифицированная подпись", "криптопровайдер", "отпечаток сертификата",
      "штамп времени", "проверка подписи", "подписание документа",
      "носитель ключа"],
     ["qualified signature", "crypto provider", "certificate thumbprint",
      "timestamp mark", "signature validation", "document signing",
      "key token"]),
    ("ocr-recognition", "распознавание документов", "document recognition",
     ["распознавание текста", "скан документа", "извлечение реквизитов",
      "качество изображения", "языковой пакет", "верификация результата",
      "поля счёта"],
     ["text recognition", "document scan", "requisite extraction",
      "image quality", "language pack", "result verification",
      "invoice fields"]),
    ("barcodes", "штрихкоды", "barcodes",
     ["генерация штрихкода", "QR-код", "сканер штрихкодов",
      "маркировка документа", "поиск по штрихкоду", "этикетка",
      "контрольная цифра"],
     ["barcode generation", "QR code", "barcode scanner",
      "document labeling", "lookup by barcode", "label sticker",
      "check digit"]),
    ("geo-maps", "карты и геоданные", "maps and geodata",
     ["точка на карте", "геокодирование адреса", "зона обслуживания",
      "маршрут выезда", "координаты записи", "слой карты",
      "ближайший исполнитель"],
     ["map pin", "address geocoding", "service area",
      "field trip route", "record coordinates", "map layer",
      "nearest agent"]),
    ("chat-messengers", "мессенджеры", "messenger integration",
     ["чат-бот", "входящее сообщение", "привязка диалога",
      "кнопки быстрых ответов", "токен бота", "групповой чат",
      "передача оператору"],
     ["chat bot", "incoming message", "conversation binding",
      "quick-reply buttons", "bot token", "group chat",
      "handover to operator"]),
    ("telephony", "телефония", "telephony",
     ["входящий звонок", "карточка звонящего", "запись разговора",
      "очередь вызовов", "IP-АТС", "переадресация",
      "журнал звонков"],
     ["incoming call", "caller card", "call recording",
      "call queue", "IP PBX", "call forwarding",
      "call log"]),
    ("knowledge-base", "база знаний", "knowledge base",
     ["статья базы знаний", "дерево разделов", "черновик статьи",
      "публикация статьи", "оценка полезности", "связанные статьи",
      "устаревший материал"],
     ["knowledge article", "section tree", "article draft",
      "article publishing", "helpfulness rating", "related articles",
      "outdated content"]),
    ("helpdesk", "служба поддержки", "helpdesk",
     ["регистрация обращения", "первая линия", "типовое решение",
      "маршрутизация заявки", "удовлетворённость клиента", "база обращений",
      "время реакции"],
     ["ticket intake", "first line", "canned solution",
      "ticket routing", "customer satisfaction", "ticket backlog",
      "response time"]),
    ("incidents", "инциденты", "incident management",
     ["массовый инцидент", "степень влияния", "рабочее решение",
      "восстановление сервиса", "связанная проблема", "карточка инцидента",
      "повторное открытие"],
     ["major incident", "impact level", "workaround fix",
      "service restoration", "linked problem", "incident card",
      "reopen event"]),
    ("problems", "управление проблемами", "problem management",
     ["корневая причина", "известная ошибка", "анализ тренда",
      "повторяющийся сбой", "постоянное решение", "разбор инцидентов",
      "база известных ошибок"],
     ["root cause", "known error", "trend analysis",
      "recurring failure", "permanent fix", "incident review",
      "known-error database"]),
    ("changes-mgmt", "управление изменениями", "change management",
     ["заявка на изменение", "комитет по изменениям", "окно обслуживания",
      "план отката", "оценка риска изменения", "стандартное изменение",
      "календарь изменений"],
     ["change request", "change advisory board", "maintenance window",
      "rollback plan", "change risk assessment", "standard change",
      "change calendar"]),
    ("releases", "релизы", "release management",
     ["состав релиза", "план развёртывания", "тестовый контур",
      "приёмочные испытания", "дата выпуска", "примечания к релизу",
      "заморозка изменений"],
     ["release scope", "deployment plan", "staging environment",
      "acceptance testing", "release date", "release notes",
      "change freeze"]),
    ("purchases", "закупки", "procurement",
     ["заявка на закупку", "выбор поставщика", "сравнение предложений",
      "лимит закупки", "позиция спецификации", "согласование закупки",
      "реестр поставщиков"],
     ["purchase request", "supplier selection", "quote comparison",
      "purchase limit", "specification line", "purchase approval",
      "supplier registry"]),
    ("invoices", "счета на оплату", "invoicing",
     ["выставление счёта", "позиция счёта", "ставка НДС",
      "срок оплаты", "статус оплаты", "счёт-фактура",
      "дублирующийся счёт"],
     ["invoice issuing", "invoice line", "VAT rate",
      "payment due date", "payment status", "tax invoice",
      "duplicate invoice"]),
    ("payments", "платежи", "payments",
     ["платёжное поручение", "график платежей", "частичная оплата",
      "сверка платежей", "валюта платежа", "назначение платежа",
      "возврат средств"],
     ["payment order", "payment schedule", "partial payment",
      "payment reconciliation", "payment currency", "payment purpose",
      "refund transfer"]),
    ("warehouse", "складской учёт", "warehouse management",
     ["остатки на складе", "приходная накладная", "отгрузка со склада",
      "инвентаризация", "ячейка хранения", "резервирование товара",
      "минимальный остаток"],
     ["stock balance", "goods receipt note", "warehouse shipment",
      "stock taking", "storage bin", "item reservation",
      "minimum stock level"]),
    ("logistics", "доставка и логистика", "delivery and logistics",
     ["маршрутный лист", "окно доставки", "трек-номер",
      "курьерская служба", "точка выдачи", "стоимость доставки",
      "подтверждение вручения"],
     ["route sheet", "delivery window", "tracking number",
      "courier service", "pickup point", "delivery cost",
      "proof of delivery"]),
    ("hr-recruiting", "подбор персонала", "recruiting",
     ["карточка кандидата", "воронка подбора", "отклик на вакансию",
      "этап собеседования", "кадровый резерв", "оффер кандидату",
      "причина отказа"],
     ["candidate card", "hiring funnel", "job application",
      "interview stage", "talent pool", "candidate offer",
      "rejection reason"]),
    ("payroll", "расчёт вознаграждений", "compensation",
     ["премиальный фонд", "коэффициент участия", "расчётный период",
      "надбавка за стаж", "удержание", "ведомость начислений",
      "индексация оклада"],
     ["bonus pool", "participation factor", "pay period",
      "tenure allowance", "deduction entry", "payout sheet",
      "salary indexation"]),
    ("performance-review", "оценка персонала", "performance review",
     ["цикл оценки", "оценка 360", "цели сотрудника",
      "форма обратной связи", "калибровка оценок", "итоговый рейтинг",
      "план развития"],
     ["review cycle", "360 feedback", "employee goals",
      "feedback form", "rating calibration", "final score",
      "development plan"]),
    ("training-courses", "учебные курсы", "training courses",
     ["учебная программа", "запись на курс", "проходной балл",
      "тест по итогам", "сертификат о прохождении", "учебные материалы",
      "посещаемость занятий"],
     ["curriculum plan", "course enrollment", "passing score",
      "final quiz", "completion certificate", "course materials",
      "class attendance"]),
    ("meeting-rooms", "бронирование переговорных", "room booking",
     ["свободный слот", "повторяющаяся бронь", "вместимость комнаты",
      "оборудование переговорной", "отмена брони", "конфликт бронирований",
      "панель у двери"],
     ["free slot", "recurring booking", "room capacity",
      "room equipment", "booking cancellation", "booking conflict",
      "door panel display"]),
    ("fleet", "автопарк", "fleet management",
     ["путевой лист", "техосмотр автомобиля", "расход топлива",
      "закрепление водителя", "страховой полис", "пробег автомобиля",
      "график обслуживания"],
     ["trip ticket", "vehicle inspection", "fuel consumption",
      "driver assignment", "insurance policy", "vehicle mileage",
      "service schedule"]),
    ("correspondence", "входящая корреспонденция", "incoming correspondence",
     ["регистрационный номер", "скан письма", "резолюция руководителя",
      "срок исполнения письма", "журнал регистрации", "ответное письмо",
      "контроль исполнения"],
     ["registration number", "letter scan", "executive resolution",
      "letter due date", "registration journal", "reply letter",
      "execution control"]),
    ("powers-of-attorney", "доверенности", "powers of attorney",
     ["срок действия доверенности", "передоверие", "отзыв доверенности",
      "полномочия представителя", "машиночитаемая доверенность",
      "реестр доверенностей", "нотариальная форма"],
     ["validity period", "sub-delegation", "revocation notice",
      "representative powers", "machine-readable form",
      "attorney registry", "notarized form"]),
    ("risk-management", "управление рисками", "risk management",
     ["реестр рисков", "вероятность наступления", "степень ущерба",
      "план снижения риска", "владелец риска", "карта рисков",
      "остаточный риск"],
     ["risk register", "occurrence probability", "damage severity",
      "mitigation plan", "risk owner", "risk heatmap",
      "residual risk"]),
    ("kpi-metrics", "ключевые показатели", "KPI metrics",
     ["целевое значение", "плановый показатель", "факт против плана",
      "весовой коэффициент", "период измерения", "карта показателей",
      "светофорная индикация"],
     ["target value", "planned figure", "actual vs plan",
      "weight coefficient", "measurement period", "scorecard view",
      "traffic-light indicator"]),
    ("analytics-bi", "бизнес-аналитика", "business analytics",
     ["срез данных", "сводная таблица", "измерение и факт",
      "детализация показателя", "источник данных", "вычисляемое поле",
      "выгрузка в хранилище"],
     ["data slice", "pivot table", "dimension and measure",
      "metric drill-down", "data source", "calculated field",
      "warehouse export"]),
    ("data-quality", "качество данных", "data quality",
     ["проверка заполненности", "формат значения", "эталонное значение",
      "отчёт о расхождениях", "правило валидации данных", "очистка данных",
      "профилирование данных"],
     ["completeness check", "value format", "golden value",
      "discrepancy report", "data validation rule", "data cleansing",
      "data profiling"]),
    ("deduplication", "поиск дубликатов", "duplicate detection",
     ["нечёткое совпадение", "слияние записей", "правило сравнения",
      "кандидаты в дубликаты", "главная запись", "порог похожести",
      "история слияний"],
     ["fuzzy match", "record merge", "comparison rule",
      "duplicate candidates", "master record", "similarity threshold",
      "merge history"]),
    ("masterdata", "нормативно-справочная информация", "master data",
     ["централизованный справочник", "код элемента", "иерархия справочника",
      "синхронизация справочников", "устаревший элемент", "эталонная запись",
      "согласование изменений НСИ"],
     ["central dictionary", "item code", "dictionary hierarchy",
      "dictionary sync", "deprecated item", "reference record",
      "master-data change approval"]),
    ("versioning-docs", "версии документов", "document versioning",
     ["история версий", "сравнение версий", "возврат к версии",
      "черновик и публикация", "номер ревизии", "блокировка на время правки",
      "автор изменения"],
     ["version history", "version diff", "revert to version",
      "draft and published", "revision number", "edit lock",
      "change author"]),
    ("retention-policy", "сроки хранения", "retention policy",
     ["срок хранения записи", "автоматическое удаление", "юридическое удержание",
      "политика уничтожения", "акт об уничтожении", "категория хранения",
      "продление срока"],
     ["record retention period", "automatic purge", "legal hold",
      "disposition policy", "destruction certificate", "retention class",
      "period extension"]),
    ("gdpr-personal-data", "персональные данные", "personal data",
     ["согласие на обработку", "обезличивание данных", "право на удаление",
      "оператор данных", "категория персональных данных", "трансграничная передача",
      "журнал доступа к данным"],
     ["processing consent", "data anonymization", "right to erasure",
      "data controller", "personal-data category", "cross-border transfer",
      "data access log"]),
    ("encryption", "шифрование", "encryption",
     ["шифрование на диске", "ключ шифрования", "ротация ключей",
      "защищённое соединение", "алгоритм шифрования", "хранилище ключей",
      "шифрование вложений"],
     ["encryption at rest", "encryption key", "key rotation",
      "secure connection", "cipher algorithm", "key vault",
      "attachment encryption"]),
    ("certificates", "сертификаты", "certificates",
     ["срок действия сертификата", "цепочка доверия", "корневой сертификат",
      "запрос на сертификат", "продление сертификата", "отозванный сертификат",
      "самоподписанный сертификат"],
     ["certificate expiry", "trust chain", "root certificate",
      "signing request", "certificate renewal", "revoked certificate",
      "self-signed certificate"]),
    ("message-queues", "очереди сообщений", "message queues",
     ["брокер сообщений", "подтверждение обработки", "повторная доставка",
      "мёртвая очередь", "порядок сообщений", "глубина очереди",
      "подписчик очереди"],
     ["message broker", "processing acknowledgement", "redelivery attempt",
      "dead-letter queue", "message ordering", "queue depth",
      "queue consumer"]),
    ("etl-pipelines", "загрузка данных ETL", "ETL pipelines",
     ["конвейер загрузки", "маппинг полей", "инкрементальная загрузка",
      "преобразование данных", "ошибки загрузки", "расписание конвейера",
      "источник и приёмник"],
     ["load pipeline", "field mapping", "incremental load",
      "data transformation", "load failures", "pipeline schedule",
      "source and sink"]),
    ("scheduled-jobs", "планировщик заданий", "job scheduler",
     ["периодическое задание", "cron-выражение", "время запуска",
      "перекрытие запусков", "журнал выполнения задания", "ручной запуск",
      "зависшее задание"],
     ["recurring job", "cron expression", "launch time",
      "run overlap", "job execution log", "manual trigger",
      "stuck job"]),
    ("monitoring-alerts", "мониторинг системы", "system monitoring",
     ["порог срабатывания", "метрика состояния", "оповещение дежурному",
      "панель состояния", "проверка доступности", "история срабатываний",
      "подавление оповещений"],
     ["alert threshold", "health metric", "on-call notification",
      "status panel", "availability probe", "alert history",
      "alert suppression"]),
    ("logs-diagnostics", "журналы и диагностика", "logs and diagnostics",
     ["уровень логирования", "ротация журналов", "диагностический пакет",
      "трассировка запроса", "код ошибки в журнале", "сбор логов",
      "корреляция событий"],
     ["log level", "log rotation", "diagnostic bundle",
      "request tracing", "logged error code", "log collection",
      "event correlation"]),
    ("clustering-ha", "кластеризация и отказоустойчивость", "clustering and high availability",
     ["узел кластера", "переключение при сбое", "кворум кластера",
      "репликация состояния", "плавающий адрес", "разделение кластера",
      "горячий резерв"],
     ["cluster node", "failover switch", "cluster quorum",
      "state replication", "floating address", "split brain",
      "hot standby"]),
    ("load-balancing", "балансировка нагрузки", "load balancing",
     ["распределение запросов", "липкая сессия", "проверка здоровья узла",
      "вес сервера", "лимит соединений", "обратный прокси",
      "вывод узла из ротации"],
     ["request distribution", "sticky session", "node health check",
      "server weight", "connection limit", "reverse proxy",
      "node drain"]),
    ("docker-deploy", "развёртывание в контейнерах", "container deployment",
     ["образ контейнера", "переменные окружения контейнера", "монтирование тома",
      "оркестратор контейнеров", "реестр образов", "проба готовности",
      "лимиты ресурсов контейнера"],
     ["container image", "container environment variables", "volume mount",
      "container orchestrator", "image registry", "readiness probe",
      "container resource limits"]),
    ("database-admin", "администрирование БД", "database administration",
     ["пул соединений БД", "медленный запрос", "индекс таблицы БД",
      "вакуумирование", "размер табличного пространства", "план запроса",
      "блокировки в БД"],
     ["database connection pool", "slow query", "database table index",
      "vacuum maintenance", "tablespace size", "query plan",
      "database locks"]),
    ("storage-files", "файловое хранилище", "file storage",
     ["квота хранилища", "внешнее хранилище", "дедупликация файлов",
      "потоковая загрузка", "контрольная сумма файла", "холодное хранение",
      "миграция хранилища"],
     ["storage quota", "external storage", "file deduplication",
      "streaming upload", "file checksum", "cold storage",
      "storage migration"]),
    ("feedback", "обратная связь", "user feedback",
     ["форма обратной связи", "оценка обращения", "жалоба клиента",
      "благодарность", "категория отзыва", "ответ на отзыв",
      "индекс лояльности"],
     ["feedback form", "ticket rating", "customer complaint",
      "appreciation note", "feedback category", "reply to feedback",
      "loyalty index"]),
    ("ratings", "рейтинги и оценки", "ratings and scores",
     ["пятибалльная шкала", "средний балл", "взвешенная оценка",
      "история оценок", "пересчёт рейтинга", "минимальный порог оценки",
      "рейтинг исполнителя"],
     ["five-point scale", "average score", "weighted rating",
      "score history", "rating recalculation", "minimum score threshold",
      "assignee rating"]),
    ("gamification", "геймификация", "gamification",
     ["значок достижения", "таблица лидеров", "очки за действие",
      "уровень участника", "награда за цель", "серия выполнений",
      "виртуальная валюта"],
     ["achievement badge", "leaderboard table", "action points",
      "member level", "goal reward", "completion streak",
      "virtual currency"]),
    ("widgets-embed", "встраиваемые виджеты", "embeddable widgets",
     ["код вставки", "виджет на сайте", "домен размещения",
      "параметры виджета", "защита от подделки запросов", "ширина и высота",
      "обновление данных виджета"],
     ["embed code", "website widget", "hosting domain",
      "widget parameters", "request forgery protection", "width and height",
      "widget data refresh"]),
    ("signatures-routes", "маршруты подписания", "signing routes",
     ["порядок подписантов", "последовательное подписание", "отклонение подписантом",
      "напоминание подписанту", "замена подписанта", "статус подписания",
      "лист согласования"],
     ["signer order", "sequential signing", "signer rejection",
      "signer reminder", "signer substitution", "signing status",
      "approval sheet"]),
]

# ------------------------------------------------------------------- facets
# slug, RU heading, EN heading, RU body template lines, EN body template lines.
# {t} = topic name, {w0}..{w2} = topic terminology words.
FACETS: list[tuple[str, str, str, list[str], list[str]]] = [
    ("setup", "Настройка", "Configuration",
     ["Чтобы настроить {t}, откройте раздел администрирования и выберите "
      "нужный элемент: {w0}.",
      "Задайте параметры: {w1} и {w2}. Сохраните изменения и проверьте "
      "результат на тестовой записи.",
      "Рекомендуется выполнять настройку под учётной записью администратора."],
     ["To configure {t}, open the administration area and select the item "
      "you need: {w0}.",
      "Set the parameters: {w1} and {w2}. Save the changes and verify the "
      "result on a test record.",
      "We recommend performing the configuration under an administrator "
      "account."]),
    ("troubleshooting", "Устранение неполадок", "Troubleshooting",
     ["Если {t} работает неправильно, сначала проверьте {w0} и изучите "
      "сообщение об ошибке.",
      "Типичная причина сбоя — некорректное значение параметра {w1}. "
      "Исправьте его и повторите операцию.",
      "Если ошибка повторяется, соберите журнал и проверьте {w2} перед "
      "обращением в поддержку."],
     ["If {t} misbehaves, first check {w0} and read the error message "
      "carefully.",
      "A typical failure cause is an invalid value of {w1}. Fix it and "
      "retry the operation.",
      "If the error persists, collect the log and inspect {w2} before "
      "contacting support."]),
    ("api-usage", "Работа через API", "API usage",
     ["Элементами «{t}» можно управлять программно: используйте {w0} в "
      "запросах к серверу.",
      "Передайте {w1} в теле запроса; сервер вернёт {w2} в формате JSON.",
      "Для аутентификации программных запросов используйте токен доступа."],
     ["You can manage {t} programmatically: use {w0} in requests to the "
      "server.",
      "Pass {w1} in the request body; the server returns {w2} as JSON.",
      "Use an access token to authenticate programmatic requests."]),
    ("permissions-for", "Права доступа", "Access control",
     ["Доступ к «{t}» регулируется ролями: назначьте {w0} только тем "
      "группам, которым это необходимо.",
      "Проверьте {w1}: без него пользователи не увидят {w2}.",
      "Изменения прав вступают в силу после повторного входа пользователя."],
     ["Access to {t} is governed by roles: grant {w0} only to the groups "
      "that need it.",
      "Check {w1}: without it users will not see {w2}.",
      "Permission changes take effect after the user signs in again."]),
    ("best-practices", "Рекомендации", "Best practices",
     ["При работе с «{t}» планируйте структуру заранее: продумайте {w0} до "
      "запуска в эксплуатацию.",
      "Избегайте избыточного количества {w1} — это усложняет сопровождение.",
      "Документируйте {w2}, чтобы команда понимала принятые решения."],
     ["When working with {t}, plan the structure upfront: think through "
      "{w0} before going live.",
      "Avoid an excessive number of {w1} — it complicates maintenance.",
      "Document {w2} so the team understands the decisions made."]),
    ("examples", "Примеры", "Examples",
     ["Пример использования «{t}»: создайте {w0} и свяжите его с типовым "
      "бизнес-сценарием.",
      "В примере ниже показано, как заполнить {w1} и получить {w2}.",
      "Готовый пример можно взять за основу и адаптировать под свой процесс."],
     ["A usage example for {t}: create {w0} and link it to a typical "
      "business scenario.",
      "The example below shows how to fill in {w1} and obtain {w2}.",
      "You can take the ready-made example as a base and adapt it to your "
      "process."]),
    ("limits", "Ограничения", "Limits",
     ["Для «{t}» действуют ограничения: максимальное количество {w0} "
      "зависит от редакции системы.",
      "Превышение лимита на {w1} приводит к предупреждению; {w2} при этом "
      "не обрабатывается.",
      "Актуальные значения лимитов приведены в примечаниях к выпуску."],
     ["The following limits apply to {t}: the maximum number of {w0} "
      "depends on the system edition.",
      "Exceeding the limit on {w1} raises a warning; {w2} is not processed "
      "in that case.",
      "Current limit values are listed in the release notes."]),
    ("migration", "Перенос", "Migration",
     ["Чтобы перенести {t} между средами, выгрузите {w0} на исходном "
      "сервере.",
      "При переносе проверьте соответствие {w1}: различия приводят к "
      "конфликтам {w2}.",
      "Перенос рекомендуется выполнять в окно обслуживания."],
     ["To migrate {t} between environments, export {w0} on the source "
      "server.",
      "During migration verify that {w1} matches: differences cause {w2} "
      "conflicts.",
      "Perform the migration during a maintenance window."]),
    ("automation", "Автоматизация", "Automation",
     ["Действия с «{t}» можно автоматизировать: настройте правило, которое "
      "срабатывает при изменении {w0}.",
      "Автоматическое правило умеет заполнять {w1} и обновлять {w2} без "
      "участия пользователя.",
      "Проверяйте журнал автоматизации, чтобы убедиться, что правило "
      "сработало в нужный момент."],
     ["Actions on {t} can be automated: set up a rule that fires whenever "
      "{w0} changes.",
      "An automatic rule can fill in {w1} and update {w2} without user "
      "involvement.",
      "Check the automation log to confirm the rule fired at the right "
      "moment."]),
    ("faq", "Частые вопросы", "FAQ",
     ["Частый вопрос по теме «{t}»: что делать, если {w0} не отображается? "
      "Обновите данные и проверьте права.",
      "Ещё один популярный вопрос касается {w1}: значение задаётся в "
      "настройках раздела.",
      "Если остались вопросы про {w2}, обратитесь к администратору "
      "системы или в службу поддержки."],
     ["A frequent question about {t}: what should you do when {w0} is not "
      "shown? Refresh the data and check permissions.",
      "Another popular question concerns {w1}: the value is defined in the "
      "section settings.",
      "If you still have questions about {w2}, contact your system "
      "administrator or the support desk."]),
]

# Second elaboration paragraph set per facet ({t}, {w0}..{w2} as above) —
# appended after the primary lines so article bodies are long enough to
# chunk (~3 chunks at the eval chunk size) and no two facets share their
# full paragraph structure.
FACET_DETAILS: dict[str, tuple[list[str], list[str]]] = {
    "setup": (
        ["После первичной настройки проверьте, как {w0} отображается у "
         "обычного пользователя: часть параметров видна только "
         "администратору.",
         "Изменения можно вносить поэтапно — система сохраняет черновик "
         "настроек, пока вы не опубликуете {w1}.",
         "Перед запуском в работу согласуйте значения {w2} с владельцем "
         "раздела."],
        ["After the initial configuration, check how {w0} looks for a "
         "regular user: some parameters are visible to administrators only.",
         "Changes can be applied gradually — the system keeps a draft of "
         "the settings until you publish {w1}.",
         "Before going live, agree on the {w2} values with the section "
         "owner."]),
    "troubleshooting": (
        ["Диагностику удобно начинать с воспроизведения проблемы на "
         "тестовой записи: так видно, связан ли сбой с данными или с "
         "настройкой {w0}.",
         "Снимок экрана с сообщением об ошибке и время воспроизведения "
         "ускоряют разбор обращения в поддержке.",
         "После исправления убедитесь, что {w1} и {w2} вернулись к "
         "штатному поведению."],
        ["It is convenient to start diagnostics by reproducing the problem "
         "on a test record: this shows whether the failure is data-related "
         "or caused by the {w0} configuration.",
         "A screenshot of the error message and the reproduction time "
         "speed up the support investigation.",
         "After the fix, make sure {w1} and {w2} are back to normal "
         "behavior."]),
    "api-usage": (
        ["Ответы сервера содержат постраничную навигацию: передавайте "
         "номер страницы, чтобы получить следующую порцию {w0}.",
         "Ошибки возвращаются с машиночитаемым кодом; обрабатывайте {w1} "
         "на стороне клиента.",
         "Для массовых операций используйте пакетные запросы — они "
         "обновляют {w2} за один вызов."],
        ["Server responses are paginated: pass the page number to fetch "
         "the next portion of {w0}.",
         "Errors come back with a machine-readable code; handle {w1} on "
         "the client side.",
         "For bulk operations use batch requests — they update {w2} in a "
         "single call."]),
    "permissions-for": (
        ["Права удобно проверять от имени пользователя: режим просмотра "
         "покажет, как выглядит {w0} для выбранной роли.",
         "Совмещение нескольких ролей даёт объединение прав; запрет "
         "всегда сильнее разрешения для {w1}.",
         "Аудит прав рекомендуется проводить регулярно, особенно после "
         "изменения {w2}."],
        ["It is convenient to verify permissions by impersonation: the "
         "preview mode shows how {w0} looks for the selected role.",
         "Combining several roles unions their rights; a deny always "
         "overrides an allow for {w1}.",
         "A regular permission audit is recommended, especially after "
         "{w2} changes."]),
    "best-practices": (
        ["Закрепите соглашения об именовании: единый стиль названий "
         "{w0} упрощает поиск и сопровождение.",
         "Выделите тестовую среду — проверяйте изменения {w1} до "
         "публикации в рабочем контуре.",
         "Назначьте владельца, отвечающего за {w2}: безхозные настройки "
         "быстро устаревают."],
        ["Agree on naming conventions: a consistent style for {w0} names "
         "simplifies search and maintenance.",
         "Set up a test environment — validate {w1} changes before "
         "publishing to production.",
         "Assign an owner responsible for {w2}: orphaned settings get "
         "stale quickly."]),
    "examples": (
        ["Сценарий можно расширить: добавьте условие на {w0}, чтобы "
         "пример покрывал и нетиповые случаи.",
         "Для самостоятельного повторения достаточно демо-данных — "
         "создайте несколько записей с разными значениями {w1}.",
         "Завершающий шаг примера — проверка результата: {w2} должен "
         "соответствовать ожидаемому значению."],
        ["The scenario can be extended: add a condition on {w0} so the "
         "example also covers non-typical cases.",
         "Demo data is enough to follow along — create a few records with "
         "different {w1} values.",
         "The final step of the example is verification: {w2} must match "
         "the expected value."]),
    "limits": (
        ["Лимиты защищают производительность: массовые операции с {w0} "
         "выполняются фоновыми порциями.",
         "При приближении к лимиту система показывает предупреждение "
         "заранее, чтобы вы успели освободить {w1}.",
         "Для расширенных редакций часть ограничений на {w2} можно "
         "увеличить по запросу."],
        ["Limits protect performance: bulk operations on {w0} run in "
         "background batches.",
         "When a limit is approached, the system warns you in advance so "
         "you can free up {w1}.",
         "In extended editions some {w2} restrictions can be raised on "
         "request."]),
    "migration": (
        ["Перед переносом зафиксируйте версию исходной среды: {w0} из "
         "более новой версии может не импортироваться в старую.",
         "Сравните журналы импорта: конфликтующие {w1} система помечает "
         "и пропускает.",
         "После переноса выполните контрольный прогон — создайте тестовую "
         "запись и проверьте {w2}."],
        ["Before the migration, note the source environment version: {w0} "
         "from a newer version may fail to import into an older one.",
         "Compare the import logs: the system marks and skips conflicting "
         "{w1}.",
         "After the migration run a smoke check — create a test record "
         "and verify {w2}."]),
    "automation": (
        ["Правила запускаются по событиям или по расписанию; для "
         "периодических задач задайте интервал обработки {w0}.",
         "Цепочки правил выполняются по порядку — следите, чтобы "
         "обновление {w1} не зациклило обработку.",
         "Отключённое правило сохраняет историю запусков, так что "
         "поведение {w2} можно проанализировать задним числом."],
        ["Rules run on events or on a schedule; for periodic jobs define "
         "the processing interval for {w0}.",
         "Rule chains execute in order — make sure updating {w1} does not "
         "create a processing loop.",
         "A disabled rule keeps its run history, so the behavior of {w2} "
         "can be analyzed retrospectively."]),
    "faq": (
        ["Вопрос о правах: почему коллега видит {w0}, а я нет? Ответ — "
         "проверьте роль и область видимости.",
         "Вопрос о данных: как быстро обновляется {w1}? Обновление "
         "происходит при сохранении записи.",
         "Вопрос об истории: где посмотреть прошлые значения {w2}? "
         "Используйте журнал изменений записи."],
        ["A permissions question: why does a colleague see {w0} while I "
         "do not? The answer — check the role and the visibility scope.",
         "A data question: how quickly does {w1} refresh? It refreshes "
         "when the record is saved.",
         "A history question: where can previous values of {w2} be seen? "
         "Use the record change log."]),
}

# Third paragraph set — again facet-specific AND topic-anchored ({t}/{w}
# slots), so later chunks of an article stay retrievable. (An earlier
# revision padded articles with a topic-term glossary + see-also links;
# that made every article of a topic lexically near-identical and
# destroyed facet discrimination — measured train-style recall fell to
# 0.25. Padding must carry facet+topic signal, not topic-generic noise.)
FACET_DETAILS2: dict[str, tuple[list[str], list[str]]] = {
    "setup": (
        ["Мастер первичной настройки «{t}» открывается из меню раздела; "
         "обязательные шаги отмечены звёздочкой.",
         "Часть значений {w0} наследуется из общих параметров системы — "
         "переопределяйте их только при необходимости.",
         "Готовую конфигурацию {w1} можно скопировать в другой раздел, "
         "чтобы не настраивать с нуля."],
        ["The initial setup wizard for {t} opens from the section menu; "
         "mandatory steps are marked with an asterisk.",
         "Some {w0} values are inherited from the global system "
         "parameters — override them only when necessary.",
         "A finished {w1} configuration can be copied to another section "
         "so you do not have to start from scratch."]),
    "troubleshooting": (
        ["Коды ошибок «{t}» расшифрованы в справочнике; по коду сразу "
         "видно, какой компонент отказал.",
         "Временное отключение сторонних расширений помогает исключить их "
         "влияние на сбой {w0}.",
         "Если проблема с {w1} появилась после обновления, сверьте "
         "примечания к выпуску — поведение могло измениться намеренно."],
        ["Error codes for {t} are explained in the reference guide; the "
         "code immediately points to the failing component.",
         "Temporarily disabling third-party extensions helps rule out "
         "their influence on the {w0} failure.",
         "If the {w1} problem appeared after an update, check the release "
         "notes — the behavior may have changed intentionally."]),
    "api-usage": (
        ["Версия api указывается в пути запроса; устаревшие версии для "
         "«{t}» продолжают работать в течение переходного периода.",
         "Тестовые вызовы с {w0} удобно выполнять из встроенной консоли "
         "без написания кода.",
         "Ограничение частоты запросов защищает сервер: при превышении "
         "вызов {w1} вернёт код 429."],
        ["The api version is part of the request path; deprecated "
         "versions for {t} keep working through a transition period.",
         "Test calls with {w0} are easy to make from the built-in console "
         "without writing code.",
         "Rate limiting protects the server: exceeding it makes the {w1} "
         "call return code 429."]),
    "permissions-for": (
        ["Матрица прав для «{t}» показывает пересечение ролей и операций "
         "в одном окне.",
         "Временный доступ к {w0} выдаётся с датой окончания и снимается "
         "автоматически.",
         "Изменения прав на {w1} записываются в журнал безопасности "
         "вместе с именем администратора."],
        ["The permission matrix for {t} shows roles versus operations in "
         "a single view.",
         "Temporary access to {w0} is granted with an end date and is "
         "revoked automatically.",
         "Changes to {w1} permissions are written to the security log "
         "together with the administrator's name."]),
    "best-practices": (
        ["Начинайте с минимальной работающей схемы «{t}» и расширяйте её "
         "по мере появления реальных запросов.",
         "Регулярно удаляйте неиспользуемые {w0} — они затрудняют поиск "
         "нужного.",
         "Собирайте обратную связь пользователей после каждого значимого "
         "изменения {w1}."],
        ["Start with a minimal working {t} scheme and extend it as real "
         "needs appear.",
         "Regularly remove unused {w0} — they make finding the right one "
         "harder.",
         "Collect user feedback after every significant {w1} change."]),
    "examples": (
        ["Все примеры по теме «{t}» проверены на демонстрационном стенде "
         "текущей версии.",
         "К каждому шагу с {w0} приложен скриншот, чтобы сверять "
         "промежуточный результат.",
         "Архив с готовой конфигурацией {w1} можно скачать и "
         "импортировать."],
        ["All {t} examples are verified on a demo stand of the current "
         "version.",
         "Every step involving {w0} includes a screenshot so you can "
         "compare the intermediate result.",
         "An archive with the ready {w1} configuration can be downloaded "
         "and imported."]),
    "limits": (
        ["Технические лимиты «{t}» отличаются от лицензионных: первые "
         "защищают сервер, вторые зависят от тарифа.",
         "Счётчик текущего использования {w0} виден в панели "
         "администрирования.",
         "Запрос на временное повышение лимита {w1} рассматривается "
         "поддержкой индивидуально."],
        ["Technical limits for {t} differ from licensing ones: the former "
         "protect the server, the latter depend on the plan.",
         "The current {w0} usage counter is visible in the administration "
         "panel.",
         "A request for a temporary {w1} limit increase is reviewed by "
         "support individually."]),
    "migration": (
        ["Формат выгрузки «{t}» обратно совместим в пределах одной "
         "мажорной версии.",
         "Идентификаторы {w0} сохраняются при переносе, поэтому ссылки не "
         "ломаются.",
         "Для больших объёмов {w1} используйте фоновый перенос с "
         "прогрессом в журнале."],
        ["The {t} export format is backward compatible within one major "
         "version.",
         "{w0} identifiers are preserved during migration, so references "
         "do not break.",
         "For large {w1} volumes use the background transfer with "
         "progress shown in the log."]),
    "automation": (
        ["Условия правил для «{t}» поддерживают сравнение значений, "
         "проверку пустоты и логические связки.",
         "Правило, меняющее {w0}, можно протестировать на выбранной "
         "записи до включения.",
         "Массовые изменения {w1} от правил помечаются служебным автором, "
         "чтобы отличать их от ручных."],
        ["Rule conditions for {t} support value comparison, emptiness "
         "checks, and logical connectors.",
         "A rule that changes {w0} can be tested on a chosen record "
         "before being enabled.",
         "Bulk {w1} changes made by rules are marked with a service "
         "author so they can be told apart from manual ones."]),
    "faq": (
        ["Раздел про «{t}» пополняется по итогам обращений в поддержку: "
         "самые частые темы попадают сюда.",
         "Если ответа про {w0} нет, задайте вопрос через форму обратной "
         "связи — ответ добавят в статью.",
         "Поиск по базе знаний находит и вопросы про {w1}, и ответы."],
        ["The {t} section grows from support tickets: the most frequent "
         "themes end up here.",
         "If the answer about {w0} is missing, ask via the feedback form "
         "— the answer will be added to the article.",
         "The knowledge base search finds both the questions about {w1} "
         "and the answers."]),
}

VERSIONS = ["v3", "v4", "v5", "v6"]   # last = current product version (top grade)
CURRENT_VERSION = VERSIONS[-1]
KB_BASE = 4001


@dataclass
class GenArticle:
    kb_id: str
    title: str
    content: str          # markdown with frontmatter
    body: str             # markdown without frontmatter
    topic: str
    facet: str
    language: str         # "ru" | "en"
    version: str          # "v4" | "v5"
    tags: list[str] = field(default_factory=list)


def _title(topic_ru: str, topic_en: str, facet_ru: str, facet_en: str,
           lang: str, version: str) -> str:
    if lang == "ru":
        return f"{facet_ru}: {topic_ru} ({version})"
    return f"{facet_en}: {topic_en} ({version})"


def generate_corpus(seed: int = 0) -> list[GenArticle]:
    """104 topics × 10 facets × 2 languages × 4 versions = 8320 articles.
    kbIds are assigned in deterministic enumeration order from KB_BASE.

    Bodies combine the primary facet template and two facet-specific,
    topic-anchored elaboration sets (``FACET_DETAILS``/``FACET_DETAILS2``)
    plus a version note — long enough that the ingest chunker splits each
    article into ~3 chunks, every chunk still carrying facet AND topic
    vocabulary, and structurally varied (paragraph rotation by (topic,
    version)) so no two articles of a facet share their exact paragraph
    order."""
    rng = random.Random(seed)
    articles: list[GenArticle] = []
    kb = KB_BASE
    for ti, (slug, t_ru, t_en, words_ru, words_en) in enumerate(TOPICS):
        for fi, (f_slug, f_ru, f_en, tmpl_ru, tmpl_en) in enumerate(FACETS):
            det_ru, det_en = FACET_DETAILS[f_slug]
            for lang in ("ru", "en"):
                for vi, version in enumerate(VERSIONS):
                    t = t_ru if lang == "ru" else t_en
                    words = words_ru if lang == "ru" else words_en
                    tmpl = tmpl_ru if lang == "ru" else tmpl_en
                    det = det_ru if lang == "ru" else det_en
                    # rotate terminology deterministically per (facet, version)
                    off = (fi + vi) % len(words)
                    w = [words[(off + i) % len(words)] for i in range(3)]
                    sub = dict(t=t, w0=w[0], w1=w[1], w2=w[2])
                    paras = [line.format(**sub) for line in tmpl]
                    # structural variation: rotate the opening paragraph
                    rot = (ti + vi) % len(paras)
                    paras = paras[rot:] + paras[:rot]
                    paras += [line.format(**sub) for line in det]
                    det2_ru, det2_en = FACET_DETAILS2[f_slug]
                    det2 = det2_ru if lang == "ru" else det2_en
                    # anchor the second detail set on the OTHER terms so
                    # later chunks carry fresh topic vocabulary
                    w2 = [words[(off + 3 + i) % len(words)] for i in range(2)]
                    sub2 = dict(t=t, w0=w2[0], w1=w2[1])
                    paras += [line.format(**sub2) for line in det2]
                    # a version-specific note + topic filler sentence make
                    # versions distinguishable without changing relevance
                    extra = rng.sample(words, k=min(3, len(words)))
                    if lang == "ru":
                        paras.append(
                            f"В версии {version} также доступны: "
                            + ", ".join(extra) + "."
                        )
                    else:
                        paras.append(
                            f"Version {version} additionally provides: "
                            + ", ".join(extra) + "."
                        )
                    title = _title(t_ru, t_en, f_ru, f_en, lang, version)
                    body = f"# {title}\n\n" + "\n\n".join(paras) + "\n"
                    tags = [slug, f_slug, lang, version]
                    fm = (
                        "---\n"
                        f"kbId: {kb}\n"
                        f"title: \"{title}\"\n"
                        f"tags: [{', '.join(tags)}]\n"
                        "---\n\n"
                    )
                    articles.append(GenArticle(
                        kb_id=str(kb), title=title, content=fm + body,
                        body=body, topic=slug, facet=f_slug,
                        language=lang, version=version, tags=tags,
                    ))
                    kb += 1
    return articles


def write_corpus(articles: list[GenArticle], out_dir) -> None:
    """Materialize as a folder of .md files (DocumentProcessor-compatible)."""
    from pathlib import Path

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    for a in articles:
        name = f"{a.topic}_{a.facet}_{a.language}_{a.version}_{a.kb_id}.md"
        (out / name).write_text(a.content, encoding="utf-8")


# ------------------------------------------------------------- user terms
# How USERS describe each topic — synonyms and colloquial task phrasings
# that do NOT appear in the article bodies. Used only to build training
# queries (the query-log analog a production embedder is adapted on): the
# model must learn the user-vocabulary → topic mapping from these, and the
# hand-judged eval queries then test that mapping with yet different
# phrasings. Terms deliberately avoid the exact eval-query word sequences.
USER_TERMS: dict[str, tuple[list[str], list[str]]] = {
    "process-designer": (
        ["маршрут согласования", "этапы согласования", "процесс зависает",
         "запуск процесса", "параллельные ветки", "бизнес-процесс",
         "движение заявки по шагам"],
        ["approval route", "approval stages", "process is stuck",
         "start a process", "parallel branches", "business process",
         "request moving through steps"]),
    "forms": (
        ["выпадающий список", "поле с датой", "форма заявки",
         "скрыть поле", "обязательное к заполнению", "поле не сохраняется"],
        ["dropdown list", "date field", "request form",
         "hide a field", "must be filled in", "field does not save"]),
    "records": (
        ["связать таблицы", "ключ записи", "пропали записи",
         "создать запись запросом", "справочник записей", "строки таблицы"],
        ["link tables", "record key", "records disappeared",
         "create a record via request", "record dictionary", "table rows"]),
    "accounts": (
        ["новый сотрудник", "пригласить пользователя", "разблокировать",
         "неверный пароль", "массово завести пользователей", "смена пароля"],
        ["new employee", "invite a user", "unlock",
         "wrong password", "bulk create users", "password change"]),
    "roles-permissions": (
        ["чужие задачи", "не видит раздел", "раздать права",
         "ролевая модель", "доступ для отдела", "закрыть доступ"],
        ["other users' tasks", "cannot see a section", "distribute rights",
         "role model", "department access", "revoke access"]),
    "notifications": (
        ["письмо-напоминание", "просроченная задача", "перестали приходить",
         "утренний дайджест", "оповещение на почту", "напоминание о сроке"],
        ["reminder email", "overdue task", "stopped arriving",
         "morning digest", "email alert", "due-date reminder"]),
    "templates": (
        ["договор по шаблону", "документ word", "пустые места вместо значений",
         "счёт в pdf", "акт из записи", "печатная форма договора"],
        ["contract from a template", "word document", "blanks instead of values",
         "pdf invoice", "statement from a record", "contract print form"]),
    "rest-api": (
        ["получить токен", "ошибка 401", "список записей запросом",
         "не авторизован", "документация api", "вызов метода"],
        ["obtain a token", "401 error", "list records via request",
         "unauthorized", "api documentation", "method call"]),
    "webhooks": (
        ["смена статуса заявки", "оповестить стороннюю систему",
         "вызов при изменении", "биллинг", "закрытие сделки",
         "отправка события наружу"],
        ["request status change", "notify a third-party system",
         "call on change", "billing", "deal closing",
         "send an event outward"]),
    "import-export": (
        ["справочник контрагентов", "ломается кириллица", "загрузить из файла",
         "выгрузить в excel", "файл с разделителями", "неверная кодировка"],
        ["counterparty dictionary", "cyrillic breaks", "load from a file",
         "export to excel", "delimited file", "wrong encoding"]),
    "backup": (
        ["ночное копирование", "перенос на новый сервер", "восстановить вчерашнюю копию",
         "сохранность данных", "копия перед обновлением", "бэкап базы"],
        ["nightly backup", "move to a new server", "restore yesterday's copy",
         "data safety", "copy before an update", "database backup"]),
    "reports": (
        ["сводный отчёт", "по отделам", "за квартал",
         "цифры для руководства", "итоги месяца", "выгрузка цифр"],
        ["summary report", "by department", "for the quarter",
         "numbers for management", "monthly totals", "figures export"]),
    "dashboards": (
        ["ключевые показатели", "стартовый экран", "экран руководителя",
         "устаревшие цифры", "графики на главной", "монитор показателей"],
        ["key metrics", "start screen", "executive screen",
         "stale numbers", "charts on the home page", "metrics monitor"]),
    "calendars": (
        ["праздничные дни в сроках", "расчёт сроков", "графики работы",
         "неверный часовой пояс", "рабочее время", "сроки с учётом выходных"],
        ["holidays in deadlines", "deadline calculation", "work schedules",
         "wrong time zone", "business hours", "deadlines excluding weekends"]),
    "email-integration": (
        ["корпоративный ящик", "приём заявок с почты", "письма не забираются",
         "создание заявки из письма", "подключить почту", "обработка входящих"],
        ["corporate mailbox", "intake of requests from mail", "mail not fetched",
         "create a request from an email", "connect mail", "inbound processing"]),
    "ldap-sso": (
        ["вход через домен", "active directory", "ошибка сертификата",
         "вход без пароля", "корпоративная учётка", "провайдер идентификации"],
        ["domain sign-in", "active directory", "certificate error",
         "passwordless sign-in", "corporate account", "identity provider"]),
    "localization": (
        ["переключить на английский", "русский интерфейс", "перевести кнопки",
         "язык системы", "формат чисел", "интерфейс на другом языке"],
        ["switch to english", "russian interface", "translate buttons",
         "system language", "number format", "interface in another language"]),
    "performance": (
        ["медленно открываются карточки", "система тормозит", "долго грузится страница",
         "большие таблицы тормозят", "ускорить работу", "высокая нагрузка"],
        ["cards open slowly", "system lags", "page takes long to load",
         "large tables are slow", "speed up", "high load"]),
    "licensing": (
        ["сколько пользователей разрешено", "продлить лицензию", "ключ активации",
         "закончилась лицензия", "докупить места", "тип лицензии"],
        ["how many users are allowed", "renew the license", "activation key",
         "license expired", "buy more seats", "license type"]),
    "mobile": (
        ["с телефона", "пуш на смартфон", "работа без интернета",
         "приложение для android", "мобильная версия", "штрихкод камерой"],
        ["from a phone", "push to a smartphone", "working without internet",
         "android app", "mobile version", "barcode via camera"]),
    "scripts-expressions": (
        ["длительность между датами", "формула если", "условие в поле",
         "вычислить значение", "функция по строке", "посчитать разницу дат"],
        ["duration between dates", "if formula", "condition in a field",
         "compute a value", "string function usage", "calculate a date difference"]),
    "version-upgrade": (
        ["план обновления", "новая версия системы", "что нового в релизе",
         "безопасно обновиться", "откатить версию", "установка патча"],
        ["upgrade plan", "new system version", "what's new in the release",
         "upgrade safely", "roll back a version", "patch installation"]),
    "audit-log": (
        ["кто изменил поле", "когда поменяли значение", "история по записи",
         "следы действий", "журнал изменений через api", "просмотр истории"],
        ["who changed a field", "when a value was changed", "record history",
         "action traces", "change log via api", "view history"]),
    "attachments": (
        ["прикрепить файл", "лимит размера", "большой файл не грузится",
         "сколько файлов можно", "просмотр вложения", "приложенные документы"],
        ["attach a file", "size limit", "large file fails to upload",
         "how many files are allowed", "view an attachment", "attached documents"]),
    "tasks": (
        ["назначить ответственного", "срок по задаче", "мои задачи",
         "передать задачу коллеге", "повторять каждую неделю", "контроль сроков"],
        ["assign a responsible person", "task deadline", "my tasks",
         "hand a task to a colleague", "repeat weekly", "deadline control"]),
    "comments-collab": (
        ["обсудить в карточке", "упомянуть коллегу", "ответить на сообщение",
         "переписка по заявке", "отметить человека", "закрепить сообщение"],
        ["discuss in a card", "mention a colleague", "reply to a message",
         "conversation on a request", "tag a person", "pin a message"]),
    "search": (
        ["не находит документ", "искать по слову", "поиск внутри файлов",
         "найти по содержимому", "строка поиска", "искать по вложениям"],
        ["does not find a document", "search by a word", "search inside files",
         "find by content", "search box", "search across attachments"]),
    "archive": (
        ["убрать в архив", "старые записи", "вернуть из архива",
         "сколько хранится", "чистка старых данных", "архивные документы"],
        ["put into the archive", "old records", "bring back from the archive",
         "how long is it kept", "old data cleanup", "archived documents"]),
    "kanban-board": (
        ["доска задач", "лимит wip", "перетащить карточку",
         "колонки по статусам", "где настраивается доска", "вид канбан"],
        ["task board", "wip limit", "drag a card",
         "columns by status", "where the board is configured", "kanban view"]),
    "sla": (
        ["нарушение сроков", "эскалация обращения", "время на ответ",
         "регламент поддержки", "просрочка по заявке", "целевое время решения"],
        ["deadline breach", "ticket escalation", "time to respond",
         "support policy", "overdue ticket", "target resolution time"]),
    "security-settings": (
        ["политика паролей", "двухфакторка", "вход по коду",
         "ограничить по ip", "безопасность входа", "время жизни сессии"],
        ["password policy", "two-factor", "code-based sign-in",
         "restrict by ip", "sign-in security", "session lifetime"]),
    "data-model": (
        ["структура данных", "типы полей", "связи между объектами",
         "перенести модель", "проектирование справочников", "схема объектов"],
        ["data structure", "field types", "relations between objects",
         "move the model", "dictionary design", "object schema"]),
    "printing": (
        ["распечатать список", "поля страницы", "альбомная ориентация",
         "предпросмотр перед печатью", "печать карточки", "шапка и подвал"],
        ["print a list", "page margins", "landscape orientation",
         "preview before printing", "print a card", "header and footer"]),
    "integrations-ext": (
        ["обмен с другой системой", "dev и prod среды", "синхронизация по расписанию",
         "сопоставить поля", "очередь обмена", "повторить отправку"],
        ["exchange with another system", "dev and prod environments",
         "scheduled synchronization", "map fields", "exchange queue",
         "retry sending"]),
    "document-flow": (
        ["зарегистрировать документ", "лист согласования", "подписать электронно",
         "входящие документы", "контроль исполнения поручений", "номер документа"],
        ["register a document", "approval sheet", "sign electronically",
         "incoming documents", "assignment execution control", "document number"]),
    "onboarding": (
        ["обучить новичков", "видеоуроки", "подсказки в интерфейсе",
         "частые вопросы", "курс для сотрудников", "как освоить систему"],
        ["train newcomers", "video tutorials", "interface hints",
         "frequent questions", "employee course", "how to master the system"]),
    "surveys": (
        ["собрать обратную связь", "опросить сотрудников", "оценка по шкале",
         "результаты голосования", "анкетирование клиентов", "форма опроса"],
        ["collect feedback", "poll employees", "scale rating",
         "voting results", "customer questionnaire", "questionnaire form"]),
    "contracts": (
        ["продлить договор", "истекает срок соглашения", "реестр соглашений",
         "типовой договор", "сумма по контракту", "согласовать с юристом"],
        ["extend a contract", "agreement term is expiring", "agreement register",
         "standard contract", "contract total", "approve with legal"]),
    "service-catalog": (
        ["заказать услугу", "список сервисов", "новая услуга в каталоге",
         "витрина услуг", "услуга для сотрудников", "страница услуги"],
        ["order a service", "list of services", "new catalog service",
         "service storefront", "employee service", "service page"]),
    "timesheets": (
        ["отметить часы", "сколько часов потрачено", "заполнить табель",
         "переработки", "время по проекту", "списать время"],
        ["log hours", "hours spent", "fill in the timesheet",
         "overtime hours", "project time", "charge time"]),
    "crm": (
        ["база клиентов", "вести сделки", "этапы продаж",
         "новый лид", "история общения", "сегментация базы"],
        ["customer database", "manage deals", "sales stages",
         "new lead", "communication history", "segment the base"]),
    "inventory": (
        ["выдать ноутбук сотруднику", "учёт техники", "где числится оборудование",
         "провести инвентаризацию", "гарантия на технику", "приход на склад"],
        ["issue a laptop to an employee", "equipment accounting",
         "where an asset is assigned", "run a stocktake",
         "hardware warranty", "warehouse receipt"]),
    "portal": (
        ["внешняя страница для клиентов", "подать заявку без входа",
         "кабинет клиента", "настроить портал",
         "страница для подачи обращений", "портал для сотрудников"],
        ["external page for customers", "submit a request without signing in",
         "client cabinet", "configure the portal",
         "request submission page", "employee portal"]),
    "org-structure": (
        ["дерево отделов", "назначить руководителя", "сотрудник сменил отдел",
         "структура компании", "кто кому подчиняется", "временное замещение"],
        ["department tree", "assign a manager", "employee changed department",
         "company structure", "reporting lines", "temporary substitution"]),
    "projects": (
        ["вести проект", "этапы и сроки", "план-график",
         "команда проекта", "контроль вех", "занятость сотрудников"],
        ["run a project", "stages and deadlines", "schedule plan",
         "project team", "milestone control", "staff occupancy"]),
    "budgeting": (
        ["контроль расходов", "превышение лимита", "бюджет отдела",
         "согласовать трату", "план против факта", "остаток по статье"],
        ["expense control", "limit exceeded", "department budget",
         "approve spending", "plan versus actuals", "line balance"]),
    "vacations": (
        ["оформить отпуск", "сколько дней осталось", "кто в отпуске",
         "перенести отпуск", "заявление на больничный", "отметить командировку"],
        ["request vacation", "days left", "who is on vacation",
         "move a vacation", "sick leave application",
         "register a business trip"]),
    "themes": (
        ["поменять логотип", "корпоративные цвета", "тёмный режим",
         "своя тема", "настроить внешний вид", "фирменный стиль"],
        ["change the logo", "corporate colors", "dark mode",
         "custom theme", "adjust the appearance", "brand style"]),
    "gantt-chart": (
        ["сдвинуть сроки мышкой", "связи между задачами", "план-график",
         "вехи на графике", "дорожная карта проекта", "график работ"],
        ["drag deadlines with the mouse", "links between tasks",
         "schedule chart", "milestones on the chart", "project roadmap",
         "work schedule"]),
    "automation-rules": (
        ["само меняет статус", "автодействие", "робот выполняет",
         "правило не срабатывает", "при создании записи сделать",
         "назначать автоматически"],
        ["status changes by itself", "auto action", "robot performs",
         "rule does not fire", "do something on record creation",
         "assign automatically"]),
    "business-calendar": (
        ["нерабочие дни", "учесть праздники", "сроки по рабочим дням",
         "сменный график", "часы работы офиса", "календарь на год"],
        ["non-working days", "account for holidays",
         "deadlines in business days", "shift pattern", "office hours",
         "yearly calendar"]),
    "escalations": (
        ["передать выше", "горит срок", "подключить руководителя",
         "вторая линия", "заявка висит без движения", "поднять приоритет"],
        ["pass upwards", "deadline is burning", "involve the manager",
         "second line", "ticket sits idle", "raise priority"]),
    "approvals-matrix": (
        ["кто согласует по сумме", "заместитель в отпуске",
         "несколько согласующих сразу", "большинством голосов",
         "передать согласование другому", "таблица ответственных"],
        ["who approves by amount", "deputy is on vacation",
         "several approvers at once", "by majority vote",
         "hand approval to someone else", "responsibility table"]),
    "digital-signature": (
        ["подписать ЭЦП", "не видит ключ", "проверить подлинность",
         "подпись недействительна", "токен с ключом", "крипта"],
        ["sign with e-signature", "key is not detected",
         "verify authenticity", "signature is invalid", "key token",
         "crypto tooling"]),
    "ocr-recognition": (
        ["распознать скан", "вытащить данные из pdf", "кривое распознавание",
         "фото документа", "авто-заполнение из скана", "плохой скан"],
        ["recognize a scan", "extract data from pdf",
         "recognition is off", "document photo", "auto-fill from scan",
         "bad quality scan"]),
    "barcodes": (
        ["наклейка с кодом", "пикнуть сканером", "куар на документе",
         "распечатать этикетки", "найти по коду", "код не читается"],
        ["code sticker", "beep with the scanner", "qr on the document",
         "print labels", "find by code", "code won't scan"]),
    "geo-maps": (
        ["показать на карте", "адрес не находится", "выездной сотрудник",
         "зона покрытия", "построить маршрут", "метки на карте"],
        ["show on the map", "address not found", "field worker",
         "coverage zone", "build a route", "pins on the map"]),
    "chat-messengers": (
        ["бот в телеграме", "написать из мессенджера", "переписка с клиентом",
         "бот не отвечает", "кнопки в чате", "перевести на человека"],
        ["telegram bot", "write from a messenger",
         "conversation with a client", "bot is silent", "chat buttons",
         "transfer to a human"]),
    "telephony": (
        ["звонок с сайта", "всплывает карточка", "прослушать запись",
         "пропущенные вызовы", "подключить АТС", "перевести звонок"],
        ["call from the website", "popup card", "listen to the recording",
         "missed calls", "connect the PBX", "transfer a call"]),
    "knowledge-base": (
        ["статья устарела", "написать инструкцию", "опубликовать статью",
         "оценить статью", "дерево категорий", "похожие статьи"],
        ["article is outdated", "write a how-to", "publish an article",
         "rate an article", "category tree", "similar articles"]),
    "helpdesk": (
        ["завести заявку", "первая линия поддержки", "типовой ответ",
         "очередь обращений", "клиент недоволен", "скорость ответа"],
        ["open a ticket", "first-line support", "canned reply",
         "ticket queue", "unhappy customer", "reply speed"]),
    "incidents": (
        ["массовый сбой", "всё лежит", "временное решение",
         "восстановить сервис", "переоткрыли инцидент", "влияние на бизнес"],
        ["mass outage", "everything is down", "temporary fix",
         "restore the service", "incident reopened", "business impact"]),
    "problems": (
        ["докопаться до причины", "повторяется каждую неделю",
         "известная ошибка", "разобрать завал инцидентов",
         "системная проблема", "навсегда починить"],
        ["dig down to the cause", "repeats every week", "known error",
         "triage the incident pile", "systemic problem", "fix for good"]),
    "changes-mgmt": (
        ["провести изменение", "окно для работ", "откатить если что",
         "согласовать с CAB", "рискованное изменение", "типовое изменение"],
        ["carry out a change", "maintenance slot", "roll back if needed",
         "clear with the CAB", "risky change", "routine change"]),
    "releases": (
        ["что вошло в релиз", "выкатить на прод", "протестировать на стенде",
         "дата выката", "ченджлог", "заморозка перед релизом"],
        ["what made the release", "ship to production", "test on staging",
         "rollout date", "changelog", "pre-release freeze"]),
    "purchases": (
        ["заявка на закупку", "выбрать поставщика", "сравнить цены",
         "превышен лимит", "закупить оборудование", "тендер"],
        ["purchase request", "pick a supplier", "compare prices",
         "limit exceeded", "procure equipment", "tender process"]),
    "invoices": (
        ["выставить счёт", "счёт не оплачен", "НДС в счёте",
         "просроченный счёт", "задвоился счёт", "закрывающие документы"],
        ["issue an invoice", "invoice unpaid", "VAT on the invoice",
         "overdue invoice", "invoice duplicated", "closing documents"]),
    "payments": (
        ["оплатить частями", "платёжка", "сверка с банком",
         "вернуть деньги", "график оплат", "не прошёл платёж"],
        ["pay in installments", "payment slip", "bank reconciliation",
         "refund the money", "payment timetable", "payment failed"]),
    "warehouse": (
        ["остатки по складу", "оприходовать товар", "провести инвентаризацию",
         "зарезервировать позицию", "товар кончается", "списать со склада"],
        ["warehouse balances", "receive goods", "run a stock count",
         "reserve an item", "stock running low", "write off stock"]),
    "logistics": (
        ["где моя посылка", "трек для клиента", "окно доставки",
         "передать курьеру", "стоимость доставки", "подтвердить получение"],
        ["where is my parcel", "tracking for the customer",
         "delivery slot", "hand to the courier", "shipping cost",
         "confirm receipt"]),
    "hr-recruiting": (
        ["воронка кандидатов", "назначить собеседование", "сделать оффер",
         "отказать кандидату", "резерв на будущее", "отклики с сайта"],
        ["candidate funnel", "schedule an interview", "make an offer",
         "reject a candidate", "pool for later", "applications from the site"]),
    "payroll": (
        ["посчитать премию", "расчётный листок", "надбавка за выслугу",
         "удержали из зарплаты", "период расчёта", "проиндексировать оклады"],
        ["calculate the bonus", "pay slip", "seniority bonus",
         "withheld from salary", "calculation period", "index salaries"]),
    "performance-review": (
        ["годовая оценка", "собрать обратную связь", "оценка от коллег",
         "цели на квартал", "итоговый балл", "план развития сотрудника"],
        ["annual review", "collect feedback", "peer assessment",
         "quarterly goals", "final grade", "employee growth plan"]),
    "training-courses": (
        ["записаться на курс", "пройти обучение", "сдать тест",
         "получить сертификат", "материалы курса", "кто не прошёл обучение"],
        ["enroll in a course", "complete the training", "pass the test",
         "get a certificate", "course materials", "who skipped training"]),
    "meeting-rooms": (
        ["забронировать переговорку", "комната занята", "еженедельная бронь",
         "переговорка на десятерых", "отменить бронь", "свободные слоты"],
        ["book a meeting room", "room is taken", "weekly booking",
         "room for ten", "cancel the booking", "free slots"]),
    "fleet": (
        ["выписать путевой лист", "машина на ТО", "расход бензина",
         "закрепить водителя", "страховка заканчивается", "пробег за месяц"],
        ["issue a trip ticket", "car in for service", "fuel usage",
         "assign a driver", "insurance expiring", "monthly mileage"]),
    "correspondence": (
        ["зарегистрировать письмо", "входящий номер", "поставить на контроль",
         "наложить резолюцию", "ответить на письмо", "журнал входящих"],
        ["register a letter", "inbound number", "put under control",
         "add a resolution", "reply to the letter", "inbound journal"]),
    "powers-of-attorney": (
        ["оформить доверенность", "доверенность истекает", "отозвать доверенность",
         "подписывать за директора", "машиночитаемая доверенность",
         "список доверенностей"],
        ["issue a power of attorney", "authority expiring",
         "revoke the authority", "sign for the director",
         "machine-readable authority", "list of authorities"]),
    "risk-management": (
        ["вести реестр рисков", "оценить вероятность", "чем грозит",
         "план на случай", "ответственный за риск", "тепловая карта"],
        ["keep a risk register", "estimate likelihood", "what it threatens",
         "contingency plan", "risk owner person", "heatmap view"]),
    "kpi-metrics": (
        ["выполнение плана", "показатели отдела", "светофор по целям",
         "вес показателя", "факт за квартал", "дашборд с KPI"],
        ["plan fulfillment", "department figures", "traffic light on goals",
         "metric weight", "quarterly actuals", "KPI dashboard"]),
    "analytics-bi": (
        ["сводная по продажам", "провалиться в цифру", "срез по регионам",
         "данные для аналитики", "посчитать поле", "выгрузить в хранилище"],
        ["sales pivot", "drill into a number", "slice by region",
         "data for analytics", "compute a field", "export to the warehouse"]),
    "data-quality": (
        ["грязные данные", "незаполненные поля", "проверка формата",
         "расхождения в данных", "почистить базу", "профиль данных"],
        ["dirty data", "empty fields", "format check",
         "data discrepancies", "clean up the database", "data profile"]),
    "deduplication": (
        ["задвоились клиенты", "склеить записи", "найти похожие",
         "какая запись главная", "порог совпадения", "история склейки"],
        ["duplicated clients", "merge records", "find similar ones",
         "which record is primary", "match threshold", "merge log"]),
    "masterdata": (
        ["единый справочник", "код в справочнике", "устаревшее значение",
         "синхронизировать справочники", "изменить НСИ", "эталонные данные"],
        ["single dictionary", "dictionary code", "obsolete value",
         "sync dictionaries", "change master data", "golden records"]),
    "versioning-docs": (
        ["вернуть старую версию", "кто правил документ", "сравнить редакции",
         "черновик не опубликован", "номер версии", "документ заблокирован"],
        ["restore an old version", "who edited the document",
         "compare revisions", "draft not published", "version number",
         "document is locked"]),
    "retention-policy": (
        ["сколько хранить", "удалить по сроку", "запрет на удаление",
         "акт уничтожения", "продлить хранение", "категория документов"],
        ["how long to keep", "delete on expiry", "deletion ban",
         "destruction act", "extend retention", "document category"]),
    "gdpr-personal-data": (
        ["согласие на обработку", "обезличить данные", "удалить по требованию",
         "кто видел данные", "персональные данные сотрудников",
         "передача за границу"],
        ["consent to processing", "anonymize the data",
         "delete on request", "who viewed the data",
         "employee personal data", "transfer abroad"]),
    "encryption": (
        ["зашифровать диск", "ключ шифрования", "сменить ключи",
         "защищённый канал", "шифровать вложения", "хранилище секретов"],
        ["encrypt the disk", "cipher key", "rotate the keys",
         "secure channel", "encrypt attachments", "secrets vault"]),
    "certificates": (
        ["сертификат истёк", "обновить сертификат", "не доверяет сертификату",
         "выпустить новый", "самоподписанный", "цепочка сертификатов"],
        ["certificate expired", "renew the certificate",
         "certificate not trusted", "issue a new one", "self-signed",
         "certificate chain"]),
    "message-queues": (
        ["очередь забилась", "сообщение потерялось", "повторная обработка",
         "мёртвые сообщения", "подключить брокер", "порядок обработки"],
        ["queue is clogged", "message got lost", "reprocessing",
         "dead messages", "hook up the broker", "processing order"]),
    "etl-pipelines": (
        ["загрузка из экселя", "маппинг колонок", "догрузить только новое",
         "загрузка упала", "по расписанию ночью", "преобразовать при загрузке"],
        ["load from excel", "column mapping", "load only the delta",
         "load crashed", "nightly schedule", "transform on load"]),
    "scheduled-jobs": (
        ["задание по расписанию", "крон выражение", "запустить вручную",
         "задание зависло", "ночной запуск", "лог выполнения"],
        ["scheduled task", "cron string", "run manually",
         "job is stuck", "overnight run", "execution log"]),
    "monitoring-alerts": (
        ["алерт дежурному", "сработал порог", "система недоступна",
         "панель здоровья", "замьютить оповещения", "история алертов"],
        ["alert the on-call", "threshold tripped", "system unavailable",
         "health panel", "mute the alerts", "alert history"]),
    "logs-diagnostics": (
        ["включить debug", "собрать логи", "код ошибки в логе",
         "логи переполнили диск", "трассировка запроса", "пакет для поддержки"],
        ["enable debug", "collect the logs", "error code in the log",
         "logs filled the disk", "trace a request", "support bundle"]),
    "clustering-ha": (
        ["второй узел", "переключение при падении", "кластер развалился",
         "реплика отстаёт", "резервный сервер", "кворум потерян"],
        ["second node", "failover on crash", "cluster fell apart",
         "replica lagging", "standby server", "quorum lost"]),
    "load-balancing": (
        ["раскидать нагрузку", "липкие сессии", "узел выпал из ротации",
         "прокси перед системой", "вес узла", "лимит коннектов"],
        ["spread the load", "sticky sessions", "node out of rotation",
         "proxy in front", "node weight", "connection cap"]),
    "docker-deploy": (
        ["поднять в докере", "образ не стартует", "пробросить том",
         "переменные окружения", "обновить образ", "лимиты по памяти"],
        ["spin up in docker", "image won't start", "mount a volume",
         "environment variables", "update the image", "memory limits"]),
    "database-admin": (
        ["тормозит база", "долгий запрос", "добавить индекс",
         "кончились соединения", "распухла таблица", "блокировки запросов"],
        ["database is slow", "long-running query", "add an index",
         "out of connections", "bloated table", "query locks"]),
    "storage-files": (
        ["место кончается", "вынести файлы наружу", "квота на отдел",
         "проверить целостность", "холодный архив", "переехать на новое хранилище"],
        ["running out of space", "offload files externally",
         "department quota", "verify integrity", "cold archive",
         "move to new storage"]),
    "feedback": (
        ["клиент оставил отзыв", "оценка после закрытия", "жалоба на сервис",
         "ответить на отзыв", "NPS опрос", "недовольный клиент"],
        ["client left a review", "rating after closure",
         "service complaint", "respond to a review", "NPS survey",
         "dissatisfied client"]),
    "ratings": (
        ["средняя оценка", "рейтинг исполнителей", "пересчитать рейтинг",
         "оценка по пятибалльной", "низкий балл", "взвешенный рейтинг"],
        ["average rating", "performer ranking", "recalculate the rating",
         "five-star score", "low score", "weighted score"]),
    "gamification": (
        ["бейджи за достижения", "доска лидеров", "начислить очки",
         "уровень игрока", "награда за серию", "внутренняя валюта"],
        ["achievement badges", "leader board", "award points",
         "player level", "streak reward", "internal currency"]),
    "widgets-embed": (
        ["вставить на сайт", "код для вставки", "виджет не грузится",
         "разрешённые домены", "размер виджета", "обновление цифр в виджете"],
        ["embed on the site", "embed snippet", "widget won't load",
         "allowed domains", "widget size", "numbers refresh in the widget"]),
    "signatures-routes": (
        ["очередь подписания", "кто ещё не подписал", "напомнить подписанту",
         "заменить подписанта", "отклонил подписание", "лист подписей"],
        ["signing queue", "who has not signed yet", "remind the signer",
         "swap the signer", "declined to sign", "signature sheet"]),
}

# --------------------------------------------------------- training queries
# Query phrasings for TRAINING pairs — deliberately different wording from
# the hand-written eval queries in judged_queries.py so eval is not train-set
# recall. {t} = topic name, {w} = a terminology word.
_TRAIN_PATTERNS_RU = {
    "setup": ["как включить {w}", "настройка {t} пошагово",
              "где задать {w}", "параметры {t}"],
    "troubleshooting": ["не работает {w}", "ошибка в {t} что делать",
                        "{w} сбой", "почему не сохраняется {w}"],
    "api-usage": ["{t} через api", "как передать {w} в запросе",
                  "программное управление {t}", "json {w}"],
    "permissions-for": ["кто имеет доступ к {t}", "выдать право на {w}",
                        "{t} видимость для группы", "запретить {w}"],
    "best-practices": ["как правильно организовать {t}",
                       "советы по {t}", "чего избегать в {t}",
                       "сколько {w} допустимо"],
    "examples": ["пример {t}", "готовый сценарий с {w}",
                 "образец настройки {t}", "демо {w}"],
    "limits": ["максимум {w}", "лимит на {w}", "ограничения {t}",
               "сколько {w} можно создать"],
    "migration": ["перенести {t} на другой сервер", "миграция {w}",
                  "выгрузка {w} между средами", "конфликт при переносе {w}"],
    "automation": ["автоматическое правило для {t}", "автоматизировать {w}",
                   "правило при изменении {w}", "авто-действие для {t}"],
    "faq": ["частые вопросы по {t}", "вопрос про {w}",
            "ответы по теме {t}", "справка по {w}"],
}
_TRAIN_PATTERNS_EN = {
    "setup": ["how to enable {w}", "step by step {t} setup",
              "where to define {w}", "{t} parameters"],
    "troubleshooting": ["{w} not working", "{t} error what to do",
                        "{w} failure", "why does {w} not save"],
    "api-usage": ["{t} via api", "how to pass {w} in a request",
                  "programmatic {t} management", "json {w}"],
    "permissions-for": ["who can access {t}", "grant right to {w}",
                        "{t} visibility for a group", "restrict {w}"],
    "best-practices": ["how to organize {t} properly",
                       "tips for {t}", "what to avoid in {t}",
                       "how many {w} are acceptable"],
    "examples": ["{t} example", "ready-made scenario with {w}",
                 "sample {t} configuration", "{w} demo"],
    "limits": ["maximum {w}", "limit on {w}", "{t} restrictions",
               "how many {w} can be created"],
    "migration": ["move {t} to another server", "{w} migration",
                  "transfer {w} between environments",
                  "conflict when migrating {w}"],
    "automation": ["automatic rule for {t}", "automate {w}",
                   "rule on {w} change", "auto action for {t}"],
    "faq": ["frequently asked questions about {t}", "question about {w}",
            "answers on {t}", "help with {w}"],
}

# ------------------------------------------------------- eval-only patterns
# HELD-OUT query phrasings: used ONLY by ``generate_eval_queries`` (never by
# ``generate_training_pairs``), so the judged eval measures generalization
# to unseen templates. Keep these disjoint from _TRAIN_PATTERNS_* above and
# from the sentence wrappers in ``generate_training_pairs``.
_EVAL_PATTERNS_RU = {
    "setup": ["с чего начать настройку {t}", "первичная конфигурация {w}",
              "включение {w} в разделе администрирования"],
    "troubleshooting": ["{w} выдаёт ошибку, как исправить",
                        "сбой при работе с {t}",
                        "диагностика проблемы с {w}"],
    "api-usage": ["управление {t} из внешнего сервиса",
                  "rest запрос для {w}",
                  "интеграция {t} с другим приложением"],
    "permissions-for": ["ограничить доступ к {w}",
                        "настройка видимости {t} по ролям",
                        "кому разрешено менять {w}"],
    "best-practices": ["как грамотно выстроить {t}",
                       "типичные ошибки при работе с {t}",
                       "рекомендации по организации {w}"],
    "examples": ["покажите образец {w}", "типовой сценарий для {t}",
                 "пошаговый пример с {w}"],
    "limits": ["какое предельное число {w}", "квота на {w}",
               "что будет при превышении {w}"],
    "migration": ["как переехать с {t} на другой контур",
                  "перенос {w} в продуктив",
                  "копирование {t} между инсталляциями"],
    "automation": ["запускать действие автоматически при {w}",
                   "робот для {t}", "настроить триггер на {w}"],
    "faq": ["подборка ответов по {t}",
            "куда смотреть, если {w} ведёт себя странно",
            "краткая справка о {w}"],
}
_EVAL_PATTERNS_EN = {
    "setup": ["where to start configuring {t}",
              "initial configuration of {w}",
              "enabling {w} in the administration area"],
    "troubleshooting": ["{w} throws an error, how to fix it",
                        "failure when working with {t}",
                        "diagnosing a problem with {w}"],
    "api-usage": ["managing {t} from an external service",
                  "rest request for {w}",
                  "integrating {t} with another application"],
    "permissions-for": ["restrict access to {w}",
                        "configuring {t} visibility by role",
                        "who is allowed to change {w}"],
    "best-practices": ["how to structure {t} well",
                       "common mistakes when working with {t}",
                       "recommendations for organizing {w}"],
    "examples": ["show a sample of {w}", "a typical scenario for {t}",
                 "a step-by-step example with {w}"],
    "limits": ["what is the maximum number of {w}", "quota on {w}",
               "what happens when {w} is exceeded"],
    "migration": ["how to move {t} to another environment",
                  "promoting {w} to production",
                  "copying {t} between installations"],
    "automation": ["run an action automatically on {w}",
                   "a robot for {t}", "set up a trigger on {w}"],
    "faq": ["a digest of answers about {t}",
            "where to look when {w} behaves strangely",
            "a quick reference on {w}"],
}


def generate_eval_queries(seed: int = 5, per_topic: int = 2
                          ) -> list[tuple[str, str, str, str]]:
    """Deterministic template-held-out judged queries: for every topic,
    ``per_topic`` (facet, language, pattern) draws from the EVAL-ONLY
    pattern tables. Every ~4th query is made mixed-language by swapping the
    topic name for its other-language form. Returns (query, language,
    topic, facet) rows — the same shape as ``judged_queries.QUERIES``."""
    rng = random.Random(seed)
    out: list[tuple[str, str, str, str]] = []
    facet_slugs = [f[0] for f in FACETS]
    for ti, (slug, t_ru, t_en, words_ru, words_en) in enumerate(TOPICS):
        facets = rng.sample(facet_slugs, k=min(per_topic, len(facet_slugs)))
        for j, f_slug in enumerate(facets):
            lang = "ru" if (ti + j) % 3 != 1 else "en"  # ~2:1 RU:EN mix
            pats = (_EVAL_PATTERNS_RU if lang == "ru"
                    else _EVAL_PATTERNS_EN)[f_slug]
            words = words_ru if lang == "ru" else words_en
            tname = t_ru if lang == "ru" else t_en
            q = rng.choice(pats).format(t=tname, w=rng.choice(words))
            qlang = lang
            if (ti + j) % 4 == 3:  # mixed: other-language topic name
                other = t_en if lang == "ru" else t_ru
                if tname in q and other.lower() != tname.lower():
                    q = q.replace(tname, other)
                    qlang = "mixed"
            out.append((q, qlang, slug, f_slug))
    return out


def generate_labeled_queries(seed: int = 11, per_topic_facet: int = 2,
                             wrap: bool = False,
                             ru_mod: int = 3,
                             ) -> list[tuple[str, str, str, str]]:
    """(query, language, topic, facet) rows drawn from the TRAINING pattern
    tables (``_TRAIN_PATTERNS_*`` — disjoint from the eval-only patterns), the
    labeled query set hard-negative mining retrieves with: each query carries
    the structural labels needed to grade its retrieved candidates, so the
    reranker trains on the embedder's *actual* error surface rather than
    random negatives. Every ~5th query swaps the topic name for its
    other-language form (the mixed-language slice the judged eval grades).

    ``wrap=True`` dresses every ~3rd query in sentence-shaped filler (the
    family-3 wraps): surface-form diversity so a CE trained on mined groups
    generalizes past the raw pattern frames (the 2x-more-epochs retrain
    overfit to the frames — more *phrasings*, not more passes)."""
    rng = random.Random(seed)
    wrap_ru = ["как сделать {q}", "подскажите, {q}", "не получается {q}",
               "вопрос про {q}", "{q} в системе"]
    wrap_en = ["how do i {q}", "help with {q}", "{q} does not work",
               "question about {q}"]
    out: list[tuple[str, str, str, str]] = []
    for ti, (slug, t_ru, t_en, words_ru, words_en) in enumerate(TOPICS):
        for fi, (f_slug, *_rest) in enumerate(FACETS):
            for j in range(per_topic_facet):
                # ru_mod=3 → ~2:1 RU:EN (the default mining mix);
                # larger values oversample RU (teardown 2c's retrain lever)
                lang = "ru" if (ti + fi + j) % ru_mod != 1 else "en"
                pats = (_TRAIN_PATTERNS_RU if lang == "ru"
                        else _TRAIN_PATTERNS_EN)[f_slug]
                words = words_ru if lang == "ru" else words_en
                tname = t_ru if lang == "ru" else t_en
                q = rng.choice(pats).format(t=tname, w=rng.choice(words))
                qlang = lang
                if (ti + fi + j) % 5 == 4:
                    other = t_en if lang == "ru" else t_ru
                    if tname in q and other.lower() != tname.lower():
                        q = q.replace(tname, other)
                        qlang = "mixed"
                if wrap and (ti + 2 * fi + j) % 3 == 2:
                    # wrap language follows the BASE sentence language (a
                    # mixed query's surface form stays natural: an EN frame
                    # with a RU topic name keeps an English wrap)
                    w = rng.choice(wrap_ru if lang == "ru" else wrap_en)
                    q = w.format(q=q)
                out.append((q, qlang, slug, f_slug))
    return out


# sentence-shaped wraps shared by the user-term (family 3) and
# cross-lingual (families 5/6, ``cross_lingual_wrap``) query builders —
# TRAIN-side surface diversity, frames disjoint from the eval patterns
_CL_WRAP_RU = ["как сделать {q}", "подскажите, {q}", "не получается {q}",
               "{q} — как настроить", "вопрос про {q}", "{q} в системе"]
_CL_WRAP_EN = ["how do i {q}", "help with {q}", "{q} does not work",
               "question about {q}", "{q} in the system"]


def generate_training_pairs(articles: list[GenArticle], seed: int = 1,
                            per_article: int = 3,
                            block_size: int = 0,
                            topics_per_block: int = 8,
                            cross_lingual_boost: int = 1,
                            cross_lingual_only: bool = False,
                            cross_lingual_wrap: bool = False,
                            cross_lingual_deep: bool = False) -> list[tuple[str, str]]:
    """(query, positive document) pairs for contrastive training; phrasings
    disjoint from the judged eval queries. Four pair families:

    1. facet-pattern queries over topic terminology (lexical grounding);
       RU articles draw one extra pattern (``ru_boost``) — the product and
       its judged eval are RU-first (~60% RU queries) while the pair
       families are otherwise language-symmetric,
    2. title ↔ body (title vocabulary),
    3. user-term queries (USER_TERMS → topic mapping; the query-log analog),
    4. cross-lingual: the RU title paired with the EN body of the same
       (topic, facet, version) and vice versa — teaches RU/EN alignment,
       without which mixed queries and other-language grade-2 docs are
       unreachable for a from-scratch model,
    5. cross-lingual QUERY → doc: a facet-pattern query phrased in one
       language paired with the other language's article of the same
       (topic, facet, version) — grade-2 relevance in the judged eval is
       50% other-language articles, and title-level alignment (family 4)
       alone leaves query-shaped sentences unaligned across languages,
    6. MIXED-SCRIPT queries: the other-language topic name embedded in a
       same-language sentence, paired with BOTH language siblings — the
       judged eval makes every ~4th query mixed this way (its weakest
       slice: judged 0.62 vs RU 0.73 / EN 0.87 in EVAL_r04), yet no
       training pair contained a mixed-script query before this family.

    7. (``cross_lingual_deep``) body ↔ body: the RU body paired with the EN
       body of the same (topic, facet, version) — full-document alignment,
       a denser signal than family 4's title-level anchor,
    8. (``cross_lingual_deep``) cross-language USER_TERMS: the user-
       vocabulary term in one language → the other language's article of
       the topic (the query-log analog of family 5).

    ``cross_lingual_boost`` multiplies families 5 and 6 (independent pattern
    draws each repeat — duplicates possible and harmless for block training);
    ``cross_lingual_wrap`` dresses every other family-5/6 query in
    sentence-shaped filler (paraphrase-surface diversity — the anti-overfit
    lever the r3 reranker retrain identified);
    ``cross_lingual_only`` keeps only families 4-8 —
    the focused curriculum for fine-tuning a dense tower whose job inside
    the hybrid embedder is exactly cross-script matching (the lexical
    block already carries the monolingual signal families 1-3 teach).

    ``block_size > 0`` arranges the output in hard-negative blocks: each
    consecutive ``block_size`` pairs draw from at most ``topics_per_block``
    topics with all-distinct positive documents, so in-batch negatives are
    mostly same-topic/other-facet (sharpens facet discrimination) and no
    batch contains two positives of the same (topic, facet) — the other
    versions/languages of a facet are grade-2 RELEVANT in the judged eval,
    so letting them into a batch as in-batch negatives trains the encoder
    to push away documents the eval rewards (measured: the doc-keyed r3
    frida-small run scored judged_avg 0.131 vs the blockless mini's 0.223).
    """
    rng = random.Random(seed)
    # (query, body, topic, block_key) — block_key identifies the SEMANTIC
    # equivalence class of the positive: no two items of one class share a
    # block, so in-batch negatives are never relevant to another item's query
    items: list[tuple[str, str, str, str]] = []
    topic_words = {t[0]: (t[3], t[4]) for t in TOPICS}
    topic_names = {t[0]: (t[1], t[2]) for t in TOPICS}
    by_key: dict[tuple[str, str, str, str], GenArticle] = {
        (a.topic, a.facet, a.language, a.version): a for a in articles
    }
    by_topic_lang: dict[tuple[str, str], list[GenArticle]] = {}
    for a in articles:
        by_topic_lang.setdefault((a.topic, a.language), []).append(a)

    for a in articles:
        pats = (_TRAIN_PATTERNS_RU if a.language == "ru"
                else _TRAIN_PATTERNS_EN)[a.facet]
        words = topic_words[a.topic][0 if a.language == "ru" else 1]
        tname = topic_names[a.topic][0 if a.language == "ru" else 1]
        n_pats = per_article + (1 if a.language == "ru" else 0)  # RU boost
        fkey = f"{a.topic}:{a.facet}"   # all versions/languages of a facet
        if not cross_lingual_only:
            chosen = rng.sample(pats, k=min(n_pats, len(pats)))
            for p in chosen:
                q = p.format(t=tname, w=rng.choice(words))
                items.append((q, a.body, a.topic, fkey))
            # 2. title ↔ body
            items.append((a.title, a.body, a.topic, fkey))
        other = by_key.get((a.topic, a.facet,
                            "en" if a.language == "ru" else "ru", a.version))
        if other is not None:
            boost = max(1, int(cross_lingual_boost))
            cl_wraps = (_CL_WRAP_RU if a.language == "ru" else _CL_WRAP_EN)

            def maybe_wrap(q: str, j: int) -> str:
                if cross_lingual_wrap and j % 2 == 1:
                    return rng.choice(cl_wraps).format(q=q)
                return q

            # 4. cross-lingual title ↔ body
            items.append((a.title, other.body, a.topic, fkey))
            if cross_lingual_deep and a.language == "ru":
                # 7. body ↔ body (once per sibling pair: keyed on RU side)
                items.append((a.body, other.body, a.topic, fkey))
                items.append((other.body, a.body, a.topic, fkey))
            # 5. cross-lingual query → other-language doc
            for j in range(boost):
                q = rng.choice(pats).format(t=tname, w=rng.choice(words))
                items.append((maybe_wrap(q, j), other.body, a.topic, fkey))
            # 6. mixed-script query → both language siblings
            oname = topic_names[a.topic][1 if a.language == "ru" else 0]
            if oname.lower() != tname.lower():
                for j in range(boost):
                    q = rng.choice(pats).format(t=oname, w=rng.choice(words))
                    items.append((maybe_wrap(q, j), a.body, a.topic, fkey))
                    items.append((maybe_wrap(q, j + 1), other.body,
                                  a.topic, fkey))

    # 3. user-term queries → a random same-language article of the topic.
    # Half of them are wrapped in sentence-shaped filler so the model learns
    # to ignore function words (eval queries are full sentences).
    # 8. (cross_lingual_deep) the same user terms → OTHER-language articles.
    wrap_ru = _CL_WRAP_RU
    wrap_en = _CL_WRAP_EN
    for slug, (terms_ru, terms_en) in USER_TERMS.items():
        if cross_lingual_only and not cross_lingual_deep:
            break
        for lang, terms in (("ru", terms_ru), ("en", terms_en)):
            pool = by_topic_lang.get((slug, lang), [])
            other_pool = by_topic_lang.get(
                (slug, "en" if lang == "ru" else "ru"), [])
            wraps = wrap_ru if lang == "ru" else wrap_en
            for term in terms:
                # bare + wrapped forms, two target articles each; key by the
                # BODY's facet class so a user-term positive never collides
                # with a facet query of the same class in one block
                forms = [term, rng.choice(wraps).format(q=term)]
                for q in forms:
                    if pool and not cross_lingual_only:
                        for a in rng.sample(pool, k=min(2, len(pool))):
                            items.append((q, a.body, a.topic,
                                          f"{slug}:{a.facet}"))
                    if cross_lingual_deep and other_pool:
                        for a in rng.sample(other_pool,
                                            k=min(2, len(other_pool))):
                            items.append((q, a.body, a.topic,
                                          f"{slug}:{a.facet}"))

    rng.shuffle(items)
    if not block_size:
        return [(q, body) for q, body, _, _ in items]
    return _arrange_blocks(items, block_size, topics_per_block, rng)


def _arrange_blocks(items, block_size: int, topics_per_block: int,
                    rng: random.Random) -> list[tuple[str, str]]:
    """Greedy hard-negative block builder (see generate_training_pairs)."""
    by_topic: dict[str, list] = {}
    for it in items:
        by_topic.setdefault(it[2], []).append(it)
    ordered: list[tuple[str, str]] = []
    while any(by_topic.values()):
        live = [t for t, lst in by_topic.items() if lst]
        rng.shuffle(live)
        chosen = sorted(live, key=lambda t: -len(by_topic[t]))[:topics_per_block]
        block: list = []
        used_docs: set[str] = set()
        # round-robin over the chosen topics; skip items whose positive doc
        # is already in the block (no duplicated positives)
        progress = True
        while len(block) < block_size and progress:
            progress = False
            for t in chosen:
                lst = by_topic.get(t) or []
                for idx in range(len(lst)):
                    if lst[idx][3] not in used_docs:
                        it = lst.pop(idx)
                        used_docs.add(it[3])
                        block.append(it)
                        progress = True
                        break
                if len(block) >= block_size:
                    break
        ordered.extend((q, body) for q, body, _, _ in block)
    return ordered
